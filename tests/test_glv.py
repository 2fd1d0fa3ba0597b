"""GLV endomorphism tests: derivation, host split, device split, e2e.

No reference analogue (the reference has no GLV, msm.rs:79-82); the oracle
is the same halo2curves-equivalent CPU MSM every e2e test uses."""

import numpy as np
import pytest

import jax.numpy as jnp

from msm_tpu.ops.glv import (
    glv_params,
    split_scalar,
    split_scalars_device,
    decompose_signed_glv,
)
from msm_tpu.oracle.pyecc import Curve
from msm_tpu.params import (
    BLS12_377,
    BLS12_381,
    BN254,
    GRUMPKIN,
    PALLAS,
    VESTA,
    SECP256K1,
    MsmConfig,
)


@pytest.mark.parametrize(
    "curve", [BN254, BLS12_377, PALLAS, BLS12_381, SECP256K1, GRUMPKIN,
              VESTA]
)
def test_glv_derivation(curve):
    g = glv_params(curve)
    r, q = curve.order, curve.modulus
    assert pow(g.lam, 3, r) == 1 and g.lam != 1
    assert pow(g.beta, 3, q) == 1 and g.beta != 1
    # basis vectors lie in the lattice and are short
    for v in (g.v1, g.v2):
        assert (v[0] + v[1] * g.lam) % r == 0
        assert max(abs(v[0]), abs(v[1])) < 2 * (1 << (r.bit_length() // 2 + 2))
    # phi(P) == lam * P on a random point, not just the generator
    cv = Curve(curve)
    P = cv.sample_points(3, seed=9)[2]
    lhs = cv.to_affine(cv.scalar_mul(P, g.lam))
    x, y = cv.to_affine(P)
    assert lhs == ((x * g.beta) % q, y)


def _adversarial_scalars(g, r, extra=200, seed=3):
    """Boundary scalars (0, 1, r-1, lambda) + half-integer-adjacent k
    (k*b_j/r within ~2^-127 of a half-integer — the t ~ +-r/2 remainder
    extremes) + random bulk. NOTE: these do NOT reach the rounding-
    correction branch (its natural trigger window is ~2^-66 wide and not
    constructable by small search); that branch is exercised by
    test_glv_rounding_correction_fires via degraded multipliers."""
    ks = [0, 1, r - 1, g.lam, r - g.lam]
    for b in (g.v2[1], -g.v1[1]):
        for m in (0, 1, 2, 5, 11):
            k = ((2 * m + 1) * r) // (2 * b)
            ks += [(k + d) % r for d in (-1, 0, 1)]
    rng = np.random.default_rng(seed)
    ks += [int.from_bytes(rng.bytes(32), "little") % r for _ in range(extra)]
    return ks


@pytest.mark.parametrize(
    "curve", [BN254, BLS12_377, PALLAS, BLS12_381, SECP256K1]
)
def test_glv_host_split(curve):
    g = glv_params(curve)
    r = curve.order
    for k in _adversarial_scalars(g, r):
        k1, k2 = split_scalar(k, g, r)
        assert (k1 + k2 * g.lam - k) % r == 0
        # the EXACT-rounding bound: this is what proves the top signed
        # window digit <= 2^15 (the 2^15+1 bucket range) for EVERY scalar
        assert abs(k1) <= g.max_component and abs(k2) <= g.max_component
        assert g.half_bits <= (r.bit_length() // 2 + 3)
    cfg = MsmConfig(curve=curve, glv=True)
    assert g.max_component < 1 << (cfg.chunk_size * cfg.num_subtasks - 1)


@pytest.mark.slow  # frozen-feature device compile sweep: full tier (scripts/ci.sh)
@pytest.mark.parametrize(
    "curve", [BN254, BLS12_377, PALLAS, BLS12_381, SECP256K1]
)
def test_glv_device_split_matches_host_exactly(curve):
    """Device Babai split == exact-rounded host split, bit for bit — on
    knife-edge scalars too (the remainder-corrected rounding makes both
    sides compute round-half-up(k*b_j/r) exactly, so device == host is the
    invariant, not merely congruence)."""
    cfg = MsmConfig(curve=curve, glv=True)
    g = glv_params(curve)
    r = curve.order
    ks = _adversarial_scalars(g, r, extra=60, seed=4)
    from msm_tpu.models.common import ints_to_u16_array

    s_u16 = ints_to_u16_array([k % (1 << 256) for k in ks])
    a1, n1, a2, n2 = split_scalars_device(jnp.asarray(s_u16), cfg)
    a1, n1, a2, n2 = map(np.asarray, (a1, n1, a2, n2))
    W = a1.shape[1]
    for i, k in enumerate(ks):
        k1 = sum(int(a1[i, j]) << (16 * j) for j in range(W))
        k2 = sum(int(a2[i, j]) << (16 * j) for j in range(W))
        if n1[i]:
            k1 = -k1
        if n2[i]:
            k2 = -k2
        assert (k1, k2) == split_scalar(k, g, r), (i, k)


@pytest.mark.slow  # frozen-feature device compile sweep: full tier (scripts/ci.sh)
@pytest.mark.parametrize(
    "curve", [BN254, BLS12_377, PALLAS, BLS12_381, SECP256K1]
)
def test_glv_rounding_correction_fires(curve):
    """Force the device rounding-correction branch and prove it lands on
    the exact split. True multipliers trigger it only in a ~2^-66-wide
    window (unfindable by search), so inject DEGRADED multipliers
    g_j - 2^62: the candidate error k*(theta + 2^62)/2^320 stays < 1 (so
    candidates remain within one of exact) but now a measurable fraction
    of random scalars need the +1 correction. The corrected device split
    must STILL equal the exact host split computed from the remainder —
    this is precisely the property that keeps |k_i| <= max_component.

    Also guards the remainder-window width: with RW words the guard
    constant 3r/2 must be representable (a 16-word window truncates it
    for secp256k1's 256-bit order, silently disabling the correction)."""
    from dataclasses import replace as dreplace

    from msm_tpu.ops.glv import M_BITS, _split_scalars_device

    cfg = MsmConfig(curve=curve, glv=True)
    g = glv_params(curve)
    r = curve.order
    E = 1 << 62
    bad = dreplace(g, g1=g.g1 - E, g2=g.g2 - E)
    rng = np.random.default_rng(11)
    ks = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(160)]
    # host-side count of degraded candidates that genuinely need the
    # correction — the test is vacuous unless some do
    half = 1 << (M_BITS - 1)
    fires = sum(
        2 * (k * b - ((k * gj + half) >> M_BITS) * r) > r
        for k in ks
        for gj, b in ((bad.g1, g.v2[1]), (bad.g2, -g.v1[1]))
    )
    assert fires > 0, "degraded multipliers never triggered — raise E"

    from msm_tpu.models.common import ints_to_u16_array

    s_u16 = ints_to_u16_array(ks)
    a1, n1, a2, n2 = map(
        np.asarray, _split_scalars_device(jnp.asarray(s_u16), cfg, bad)
    )
    W = a1.shape[1]
    for i, k in enumerate(ks):
        k1 = sum(int(a1[i, j]) << (16 * j) for j in range(W))
        k2 = sum(int(a2[i, j]) << (16 * j) for j in range(W))
        if n1[i]:
            k1 = -k1
        if n2[i]:
            k2 = -k2
        assert (k1, k2) == split_scalar(k, g, r), (i, k, fires)


@pytest.mark.slow  # frozen feature: full tier
def test_glv_decompose_digits_in_bucket_range():
    """Every signed window digit of the device GLV decomposition stays in
    the bucket range [0, 2^15] — including for knife-edge scalars whose
    split components sit at the max_component bound (the round-1 design's
    truncation slop could push the TOP window digit past the bucket count,
    silently dropping points)."""
    from msm_tpu.ops.glv import decompose_signed_glv

    for curve in (BN254, SECP256K1):
        cfg = MsmConfig(curve=curve, glv=True)
        g = glv_params(curve)
        r = curve.order
        ks = _adversarial_scalars(g, r, extra=40, seed=5)
        from msm_tpu.models.common import ints_to_u16_array

        s_u16 = ints_to_u16_array([k % (1 << 256) for k in ks])
        keys, _ = decompose_signed_glv(
            jnp.asarray(s_u16), cfg.chunk_size, cfg.num_subtasks, cfg
        )
        assert int(jnp.max(keys)) <= 1 << (cfg.chunk_size - 1), curve.name
        assert keys.shape[0] == cfg.num_subtasks


def _msm_fixture(n, seed):
    cv = Curve(BN254)
    base = [cv.to_affine(p) for p in cv.sample_points(32, seed=seed)]
    pts = [base[i % len(base)] for i in range(n)]
    rng = np.random.default_rng(seed + 1)
    ks = [
        int.from_bytes(rng.bytes(32), "little") % BN254.order
        for _ in range(n)
    ]
    return pts, ks


# one GLV e2e stays in the default tier (chunk 8, cheapest compile);
# the production chunk-16 program and the other curves are full-tier
@pytest.mark.parametrize(
    "chunk", [8, pytest.param(16, marks=pytest.mark.slow)]
)
def test_glv_msm_e2e(chunk):
    from msm_tpu.models.cuzk import compute_msm_jpoint
    from msm_tpu.oracle import best_msm

    cv = Curve(BN254)
    pts, ks = _msm_fixture(257, seed=21)
    cfg = MsmConfig(curve=BN254, chunk_size=chunk, glv=True)
    got = compute_msm_jpoint(pts, ks, config=cfg)
    assert cv.eq(got, best_msm(pts, ks))


@pytest.mark.slow  # frozen feature: full tier
def test_glv_msm_e2e_secp256k1():
    """secp256k1 — the GLV paper's own curve: a = 0, even-bit zero-slack
    modulus (21 limbs), endomorphism derived numerically like the rest."""
    from msm_tpu.models.cuzk import compute_msm_jpoint

    cv = Curve(SECP256K1)
    pts = [cv.to_affine(p) for p in cv.sample_points(33, seed=12)]
    rng = np.random.default_rng(13)
    ks = [
        int.from_bytes(rng.bytes(32), "little") % SECP256K1.order
        for _ in range(33)
    ]
    cfg = MsmConfig(curve=SECP256K1, chunk_size=8, glv=True)
    got = compute_msm_jpoint(pts, ks, cfg)
    want = cv.msm([cv.from_affine(*p) for p in pts], ks)
    assert cv.eq(got, want)


@pytest.mark.slow  # frozen feature: full tier
@pytest.mark.parametrize("curve", [PALLAS, BLS12_381], ids=lambda c: c.name)
def test_glv_msm_e2e_more_curves(curve):
    """Pallas (negative reduced-basis signs pre-normalization) and
    BLS12-381 (dense 255-bit order — the remainder window that misfires
    with a sloppy guard) through the full GLV pipeline."""
    from msm_tpu.models.cuzk import compute_msm_jpoint

    cv = Curve(curve)
    pts = [cv.to_affine(p) for p in cv.sample_points(29, seed=14)]
    rng = np.random.default_rng(15)
    ks = [
        int.from_bytes(rng.bytes(32), "little") % curve.order
        for _ in range(29)
    ]
    cfg = MsmConfig(curve=curve, chunk_size=8, glv=True)
    got = compute_msm_jpoint(pts, ks, cfg)
    want = cv.msm([cv.from_affine(*p) for p in pts], ks)
    assert cv.eq(got, want)


@pytest.mark.slow  # frozen feature: full tier
def test_glv_msm_e2e_bls12_377():
    from msm_tpu.models.cuzk import compute_msm_jpoint
    from msm_tpu.oracle import best_msm

    cv = Curve(BLS12_377)
    base = [cv.to_affine(p) for p in cv.sample_points(16, seed=3)]
    pts = [base[i % len(base)] for i in range(64)]
    rng = np.random.default_rng(7)
    ks = [
        int.from_bytes(rng.bytes(32), "little") % BLS12_377.order
        for _ in range(64)
    ]
    cfg = MsmConfig(curve=BLS12_377, chunk_size=8, glv=True)
    got = compute_msm_jpoint(pts, ks, config=cfg)
    assert cv.eq(got, best_msm(pts, ks, curve=BLS12_377))


@pytest.mark.slow  # frozen feature: full tier
def test_glv_fused_pipeline_interpret():
    """GLV x the packed triple-row table (x, beta*x, y) at a multi-step
    scan geometry: the phi bit riding the sort payload must select beta*x
    inside the scan for every phi column."""
    from msm_tpu.models.cuzk import compute_msm_jpoint
    from msm_tpu.models.geometry import MsmGeometry
    from msm_tpu.oracle import best_msm

    cv = Curve(BN254)
    pts, ks = _msm_fixture(4096, seed=22)
    cfg = MsmConfig(curve=BN254, chunk_size=8, glv=True)
    geom = MsmGeometry(num_rows=256, bpr_threads=64, subtask_batch=4)
    got = compute_msm_jpoint(pts, ks, config=cfg, geometry=geom)
    assert cv.eq(got, best_msm(pts, ks))


@pytest.mark.slow  # frozen feature: full tier
def test_glv_decompose_digits_reconstruct():
    cfg = MsmConfig(curve=BN254, glv=True)
    g = glv_params(BN254)
    r = BN254.order
    c, S = cfg.chunk_size, cfg.num_subtasks
    assert S == 8, S  # the headline halving vs 16
    rng = np.random.default_rng(5)
    ks = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(40)]
    from msm_tpu.models.common import ints_to_u16_array

    s_u16 = ints_to_u16_array([k % (1 << 256) for k in ks])
    keys, signs = decompose_signed_glv(jnp.asarray(s_u16), c, S, cfg)
    keys, signs = np.asarray(keys), np.asarray(signs)
    n = len(ks)
    assert keys.shape == (S, 2 * n)
    for i, k in enumerate(ks):
        # digits of column i (k1 half) and column n+i (k2 half) must
        # reconstruct a pair congruent to k via lambda
        k1 = sum(
            (-1 if signs[j, i] else 1) * int(keys[j, i]) << (c * j)
            for j in range(S)
        )
        k2 = sum(
            (-1 if signs[j, n + i] else 1) * int(keys[j, n + i]) << (c * j)
            for j in range(S)
        )
        assert (k1 + k2 * g.lam - k) % r == 0, i
        assert (keys[:, i] <= cfg.num_buckets - 1).all()


def test_glv_payload_decode_step_major():
    """The triple-table payload decode: phi bit (index >= table_rows) moves
    to bit 1 of the flag row, sign stays bit 0, and the returned
    permutation is the physical row — in step-major order."""
    import jax.numpy as jnp

    from msm_tpu.ops.scan import _decode_payload_step_major

    n, R = 32, 4  # stream of 2*16 logical columns over a 16-row table
    table_rows = 16
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 2 * table_rows, size=n).astype(np.int32)
    sg = rng.integers(0, 2, size=n).astype(np.int32)
    sbit = max((n - 1).bit_length(), 1)
    pv = jnp.asarray(idx | (sg << sbit))
    perm, fl = _decode_payload_step_major(pv, sbit, R, table_rows=table_rows)
    perm, fl = np.asarray(perm), np.asarray(fl)
    C = n // R
    for c in range(C):
        for r in range(R):
            j = r * C + c  # lane r owns the contiguous sorted range
            k = c * R + r  # step-major flat position
            assert perm[k] == idx[j] % table_rows
            assert fl[k] == (sg[j] | ((idx[j] // table_rows) << 1))
