"""Bucket-scan parity tests.

Validates the production packed-row mixed-add scan
(``scan.sorted_prefix_scan``: packed canonical rows, signed flags, RCB16
mixed additions) against the generic projective ``blocked_prefix_scan`` and
against exact python-int prefix sums — the analogue of the reference's
stage-level SMVP parity test (``tests/smvp_shader.rs:292-334`` asserting GPU
bucket sums == ``cpu_smvp_signed``). The module name dates from the first
hardware target's Pallas scan kernel; every stage here is XLA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from msm_tpu.models import common
from msm_tpu.ops.curve import PointBatch, get_curve_ctx
from msm_tpu.ops.packing import coord_words, pack_coords
from msm_tpu.ops.scan import blocked_prefix_scan, sorted_prefix_scan
from msm_tpu.oracle.pyecc import Curve
from msm_tpu.params import BLS12_377, BLS12_381, BN254, PALLAS, MsmConfig

CFG = MsmConfig(curve=BN254)


def _scan_inputs(cfg, C, R, seed):
    """Step-major packed rows + random sign flags for C x R points, and the
    same signed points as a PointBatch in lane-major order."""
    ec = get_curve_ctx(cfg)
    cv = Curve(cfg.curve)
    n = C * R
    aff = [cv.to_affine(p) for p in cv.sample_points(32, seed=seed)]
    pts_a = [aff[i % 32] for i in range(n)]
    x_u16, y_u16, _ = common.pad_inputs(pts_a, [0] * n, cfg)
    pts = common.u16_to_mont_points(
        ec, jnp.asarray(x_u16)[:n], jnp.asarray(y_u16)[:n]
    )
    signs = np.random.default_rng(seed).integers(0, 2, size=n).astype(np.int32)
    table = common.pack_points(pts, cfg)

    def step_major(a):  # lane-major [n, ...] -> step-major [n, ...]
        return a.reshape((R, C) + a.shape[1:]).swapaxes(0, 1).reshape(a.shape)

    spts = ec.neg_where(jnp.asarray(signs).astype(bool), pts)
    return (
        ec, pts_a, signs, step_major(table),
        step_major(jnp.asarray(signs)), spts,
    )


def _check_against_blocked(cfg, C, R, seed):
    ec, _, _, rows, flags, spts = _scan_inputs(cfg, C, R, seed)
    got, got_off = jax.jit(
        lambda r, f: sorted_prefix_scan(ec, r, f, R)
    )(rows, flags)
    want, want_off = blocked_prefix_scan(ec, spts, R)
    assert bool(jnp.all(ec.eq(want, got)))
    assert bool(jnp.all(ec.eq(want_off, got_off)))


def test_fused_scan_matches_blocked_scan():
    """The packed-row mixed-add scan vs the generic projective scan:
    row prefixes and exclusive lane offsets, signed points, BN254."""
    _check_against_blocked(CFG, C=4, R=128, seed=5)


@pytest.mark.parametrize("curve", [BLS12_377, PALLAS], ids=lambda c: c.name)
def test_fused_scan_other_curves(curve):
    """Limb-geometry genericity: BLS12-377 (30 limbs, zero-slack modulus)
    and Pasta (21 limbs: the top limb lies above the packed width)."""
    _check_against_blocked(MsmConfig(curve=curve), C=2, R=64, seed=11)


@pytest.mark.parametrize(
    "curve", [BN254, BLS12_377, BLS12_381, PALLAS], ids=lambda c: c.name
)
def test_xla_scan_matches_python_ints(curve):
    """Every row prefix of the production scan, canonicalized, equals the
    exact python-int running sum of the signed points in its lane."""
    cfg = MsmConfig(curve=curve)
    C, R = 3, 8
    ec, pts_a, signs, rows, flags, _ = _scan_inputs(cfg, C, R, seed=2)
    row_prefix, _ = jax.jit(
        lambda r, f: sorted_prefix_scan(ec, r, f, R)
    )(rows, flags)
    std = np.asarray(common.export_points_std(ec, row_prefix))  # [C,R,3,L]
    cv = Curve(curve)
    for r in range(R):
        acc = None
        for c in range(C):
            x, y = pts_a[r * C + c]
            pt = cv.from_affine(x, (-y) % curve.modulus if signs[r * C + c]
                                else y)
            acc = pt if acc is None else cv.add(acc, pt)
            got = common.std_point_to_jpoint(std[c, r], cfg)
            assert cv.eq(got, acc), (r, c)


def test_window_sum_telescoping_matches_bpr():
    """The telescoped reduction (window_sum_from_pe) must equal the
    reference-shaped running-sum BPR on a real boundary-prefix structure."""
    from msm_tpu.ops.scan import (
        bucket_reduce_running,
        hillis_steele_prefix,
        window_sum_from_pe,
    )

    ec = get_curve_ctx(CFG)
    cv = Curve(CFG.curve)
    NB = 257
    pts_j = cv.sample_points(64, seed=9)
    aff = [cv.to_affine(p) for p in pts_j]
    pts_a = [aff[i % 64] for i in range(NB)]
    x_u16, y_u16, _ = common.pad_inputs(pts_a, [0] * NB, CFG)
    pts = common.u16_to_mont_points(
        ec, jnp.asarray(x_u16)[:NB], jnp.asarray(y_u16)[:NB]
    )
    pe = hillis_steele_prefix(ec, pts)
    ident1 = ec.identity((1,))
    prev = PointBatch(
        jnp.concatenate([ident1.x, pe.x[:-1]]),
        jnp.concatenate([ident1.y, pe.y[:-1]]),
        jnp.concatenate([ident1.z, pe.z[:-1]]),
    )
    buckets = ec.add(pe, ec.neg(prev))
    want = bucket_reduce_running(ec, buckets)
    got = window_sum_from_pe(ec, pe)
    assert bool(jnp.all(ec.eq(want, got)))


def _dense_to_int(row: np.ndarray) -> int:
    """[D] int32 dense words -> the packed integer (words are raw u32)."""
    v = 0
    for k, word in enumerate(row.astype(np.int64) & 0xFFFFFFFF):
        v |= int(word) << (32 * k)
    return v


def test_pack_roundtrip():
    """pack_coords canonicalizes then bit-packs at radix 2^32: the packed
    integer must equal (value mod p) for balanced-limb inputs, including
    values in [p, 2p) (the conditional-subtract path)."""
    from msm_tpu.utils.limbs import int_to_limbs

    p = CFG.curve.modulus
    rng = np.random.default_rng(1)
    vals = [0, 1, p - 1, p + 1, 2 * p - 1] + [
        int.from_bytes(rng.bytes(32), "little") % (2 * p) for _ in range(27)
    ]
    x = jnp.asarray(
        np.stack([
            int_to_limbs(v, CFG.word_size, CFG.num_words) for v in vals
        ]).astype(np.int64),
        jnp.int32,
    )
    packed = np.asarray(pack_coords(x, CFG))
    assert packed.shape == (len(vals), coord_words(CFG))
    for i, v in enumerate(vals):
        assert _dense_to_int(packed[i]) == v % p, (i, v)
