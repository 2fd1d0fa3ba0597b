"""Curve-op tests vs the python-int oracle — mirrors reference
tests/point.rs:125-187 (add, add_identity, negate, double_and_add) and adds
a differential check between the complete-formula (production) and Jacobian
(parity) implementations, incl. the edge cases the reference's branches
handle (identity operands, P+P, P+(-P))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from msm_tpu.ops.curve import CurveCtx, JacobianCtx, PointBatch
from msm_tpu.oracle.pyecc import Curve, JPoint
from msm_tpu.params import BLS12_377, BN254, MsmConfig
from msm_tpu.utils import limbs as L

CFG = MsmConfig(curve=BN254)
EC = CurveCtx(CFG)
JC = JacobianCtx(CFG)
CV = Curve(BN254)
P = BN254.modulus
W, NW = CFG.word_size, CFG.num_words


def to_batch(ec, pts: list[JPoint]) -> PointBatch:
    """Oracle points -> Montgomery projective/Jacobian limb batch.
    (Both coordinate systems agree on affine embedding z=1.)"""
    xs, ys, zs = [], [], []
    for p in pts:
        if p.is_identity():
            xs.append(0), ys.append(1), zs.append(0)
        else:
            x, y = CV.to_affine(p)
            xs.append(x), ys.append(y), zs.append(1)
    r = CFG.r

    def lim(vals):
        return jnp.asarray(
            L.ints_to_limbs([v * r % P for v in vals], W, NW).astype(np.int32)
        )

    return PointBatch(lim(xs), lim(ys), lim(zs))


def from_batch(pb: PointBatch) -> list[JPoint]:
    """Limb batch (Montgomery, balanced rep) -> oracle points (canonicalizes
    each coordinate on device first)."""
    rinv = CFG.rinv
    f = EC.f
    xs = L.limbs_to_ints(np.asarray(f.canonical(pb.x)), W)
    ys = L.limbs_to_ints(np.asarray(f.canonical(pb.y)), W)
    zs = L.limbs_to_ints(np.asarray(f.canonical(pb.z)), W)
    return [
        JPoint(x * rinv % P, y * rinv % P, z * rinv % P)
        for x, y, z in zip(xs, ys, zs)
    ]


def proj_to_oracle(pj: JPoint) -> JPoint:
    """Homogeneous projective -> comparable form via affine (x/z, y/z)."""
    if pj.z == 0:
        return JPoint(0, 1, 0)
    zi = pow(pj.z, -1, P)
    return JPoint(pj.x * zi % P, pj.y * zi % P, 1)


def jac_to_oracle(pj: JPoint) -> JPoint:
    return pj  # oracle is Jacobian already


PTS = CV.sample_points(8, seed=20)
QTS = CV.sample_points(8, seed=21)


def test_complete_add_random():
    got = from_batch(jax.jit(EC.add)(to_batch(EC, PTS), to_batch(EC, QTS)))
    for g, a, b in zip(got, PTS, QTS):
        assert CV.eq(proj_to_oracle(g), CV.add(a, b))


def test_complete_add_edge_cases():
    I = JPoint(0, 1, 0)
    a = PTS[0]
    cases_p = [I, a, a, a, I]
    cases_q = [a, I, a, CV.neg(a), I]
    got = from_batch(EC.add(to_batch(EC, cases_p), to_batch(EC, cases_q)))
    want = [CV.add(p, q) for p, q in zip(cases_p, cases_q)]
    for g, w in zip(got, want):
        assert CV.eq(proj_to_oracle(g), w)


def test_complete_double():
    got = from_batch(jax.jit(EC.double)(to_batch(EC, PTS)))
    for g, a in zip(got, PTS):
        assert CV.eq(proj_to_oracle(g), CV.double(a))
    # double of identity
    gi = from_batch(EC.double(to_batch(EC, [JPoint(0, 1, 0)])))[0]
    assert proj_to_oracle(gi).is_identity()


def test_negate():
    got = from_batch(EC.neg(to_batch(EC, PTS)))
    for g, a in zip(got, PTS):
        assert CV.eq(proj_to_oracle(g), CV.neg(a))


def test_neg_where():
    mask = jnp.asarray([True, False] * 4)
    got = from_batch(EC.neg_where(mask, to_batch(EC, PTS)))
    for i, (g, a) in enumerate(zip(got, PTS)):
        want = CV.neg(a) if i % 2 == 0 else a
        assert CV.eq(proj_to_oracle(g), want)


def test_double_and_add():
    ks = [0, 1, 2, 5, 255, 256, 65535, 12345]
    kj = jnp.asarray(ks, dtype=jnp.int32)
    got = from_batch(jax.jit(lambda p, k: EC.double_and_add(p, k, 16))(to_batch(EC, PTS), kj))
    for g, a, k in zip(got, PTS, ks):
        assert CV.eq(proj_to_oracle(g), CV.scalar_mul(a, k))


def test_projective_eq():
    pb = to_batch(EC, PTS)
    qb = to_batch(EC, QTS)
    assert np.asarray(EC.eq(pb, pb)).all()
    assert not np.asarray(EC.eq(pb, qb)).any()
    # identity equality with non-canonical identity encoding
    i1 = EC.identity((2,))
    i2 = EC.neg(EC.identity((2,)))
    assert np.asarray(EC.eq(i1, i2)).all()


def test_to_affine_mont():
    pb = EC.add(to_batch(EC, PTS), to_batch(EC, QTS))
    ax, ay = EC.to_affine_mont(pb)
    rinv = CFG.rinv
    for i in range(8):
        x = L.limbs_to_int(np.asarray(ax)[i], W) * rinv % P
        y = L.limbs_to_int(np.asarray(ay)[i], W) * rinv % P
        want = CV.to_affine(CV.add(PTS[i], QTS[i]))
        assert (x, y) == want


# -- Jacobian parity implementation ------------------------------------------


def test_jacobian_add_matches_oracle():
    got = from_batch(jax.jit(JC.add)(to_batch(JC, PTS), to_batch(JC, QTS)))
    for g, a, b in zip(got, PTS, QTS):
        assert CV.eq(g, CV.add(a, b))


def test_jacobian_edge_cases():
    I = JPoint(0, 1, 0)
    a = PTS[1]
    cases_p = [I, a, a, a]
    cases_q = [a, I, a, CV.neg(a)]
    got = from_batch(JC.add(to_batch(JC, cases_p), to_batch(JC, cases_q)))
    want = [CV.add(p, q) for p, q in zip(cases_p, cases_q)]
    for g, w in zip(got, want):
        assert CV.eq(g, w)


def test_jacobian_vs_complete_differential():
    # chained adds through both implementations land on the same group elt
    pb_c = to_batch(EC, PTS)
    pb_j = to_batch(JC, PTS)
    acc_c = EC.add(EC.double(pb_c), pb_c)  # 3P
    acc_j = JC.add(JC.double(pb_j), pb_j)
    gc = [proj_to_oracle(g) for g in from_batch(acc_c)]
    gj = from_batch(acc_j)
    for a, b in zip(gc, gj):
        assert CV.eq(a, b)


def test_bls12_377_curve_ops():
    cfg = MsmConfig(curve=BLS12_377)
    ec = CurveCtx(cfg)
    cv = Curve(BLS12_377)
    p = BLS12_377.modulus
    pts = cv.sample_points(3, seed=1)
    qts = cv.sample_points(3, seed=2)

    def tob(pl):
        xs = [cv.to_affine(pt)[0] * cfg.r % p for pt in pl]
        ys = [cv.to_affine(pt)[1] * cfg.r % p for pt in pl]
        zs = [cfg.r % p] * len(pl)
        mk = lambda vs: jnp.asarray(
            L.ints_to_limbs(vs, cfg.word_size, cfg.num_words).astype(np.int32)
        )
        return PointBatch(mk(xs), mk(ys), mk(zs))

    got = ec.add(tob(pts), tob(qts))
    rinv = cfg.rinv
    for i in range(3):
        x = L.limbs_to_int(np.asarray(ec.f.canonical(got.x))[i], cfg.word_size) * rinv % p
        y = L.limbs_to_int(np.asarray(ec.f.canonical(got.y))[i], cfg.word_size) * rinv % p
        z = L.limbs_to_int(np.asarray(ec.f.canonical(got.z))[i], cfg.word_size) * rinv % p
        zi = pow(z, -1, p)
        want = cv.to_affine(cv.add(pts[i], qts[i]))
        assert (x * zi % p, y * zi % p) == want


@pytest.mark.parametrize(
    "curve_name,chunk",
    [
        # all 7 curves x {production, small} chunk sizes: the renorm
        # fold's bound depends on fold_s = f(modulus_bits, word_size, L),
        # which varies with each curve's slack (VERDICT r4 item 9). The
        # original r4 repro is secp256k1 chunk 13. Three representative
        # params stay in the default tier (~45 s each: the repro, the
        # max-slack BN254, the r4-new cycle partner); the full 7x2 sweep
        # incl. the zero-slack L=30 BLS curves runs in the slow tier.
        (name, chunk)
        if (name, chunk) in (
            ("secp256k1", 13), ("bn254", 8), ("vesta", 8),
        )
        else pytest.param(name, chunk, marks=pytest.mark.slow)
        for name in (
            "bn254", "bls12_377", "bls12_381", "pallas", "secp256k1",
            "grumpkin", "vesta",
        )
        for chunk in (8, 13)
    ],
)
def test_double_chain_bounded_with_R_offset_representation(curve_name, chunk):
    """Regression (r4, fuzz_e2e seed 0 trial 1): a field element whose limb
    representation carries a -R offset (top limb -2^w from the sweep's
    exact-top-overflow rule) is value-correct mod p but magnitude ~R, and
    magnitude-R values are a FIXED POINT of mont_mul (R*R/R = R) that the
    RCB16 add chains amplify ~8x per point op until int32 limbs overflow
    (observed at iteration 7 of a secp256k1 window-sum doubling ladder).
    The top-limb renormalization fold in FieldCtx.mont_mul must keep a
    12-double chain exact AND limb-bounded, both op-by-op and as the jitted
    fori_loop the device Horner ladder runs."""
    import jax

    from msm_tpu.ops.curve import get_curve_ctx
    from msm_tpu.params import CURVES

    # every param compiles fresh programs (unique cfg); without this the
    # in-process jit caches accumulate across the 14 params until the CPU
    # backend segfaults (~param 12 on a 128 GB box — same failure mode the
    # fuzzer guards against, scripts/fuzz_e2e.py)
    jax.clear_caches()
    spec = CURVES[curve_name]
    cfg = MsmConfig(curve=spec, chunk_size=chunk)
    cv = Curve(spec)
    p = spec.modulus
    ec = get_curve_ctx(cfg)
    g = cv.sample_points(1, seed=5)[0]
    gx, gy = cv.to_affine(g)
    mont = lambda v: (v * cfg.r) % p
    lx = L.int_to_limbs(mont(gx), cfg.word_size, cfg.num_words).astype(np.int64)
    ly = L.int_to_limbs(mont(gy), cfg.word_size, cfg.num_words).astype(np.int64)
    lz = L.int_to_limbs(mont(1), cfg.word_size, cfg.num_words).astype(np.int64)
    # inject a magnitude-R representation of the SAME residue into y:
    # value -= R (top limb -2^w, the sweep's exact-top-overflow form as
    # produced in the wild), then value += (R mod p) — residue unchanged,
    # |value| ~ R. The pre-fix code amplified this to int32 overflow by
    # iteration 7 of the doubling chain.
    ly[-1] -= 1 << cfg.word_size
    ly += L.int_to_limbs(
        (1 << cfg.word_size * cfg.num_words) % p,
        cfg.word_size, cfg.num_words,
    ).astype(np.int64)
    d = PointBatch(*[jnp.asarray(a, jnp.int32) for a in (lx, ly, lz)])
    gd = cv.from_affine(gx, gy)
    rinv = cfg.rinv
    gg = gd
    for _ in range(12):
        gg = cv.double(gg)
    ladder = jax.jit(
        lambda p: jax.lax.fori_loop(0, 12, lambda _, a: ec.double(a), p)
    )
    for mode in ("op_by_op", "fori_loop"):
        if mode == "fori_loop":
            dd = ladder(d)
        else:
            dd = d
            for _ in range(12):
                dd = ec.double(dd)
        X = L.limbs_to_int(np.asarray(dd.x, np.int64), cfg.word_size) * rinv % p
        Y = L.limbs_to_int(np.asarray(dd.y, np.int64), cfg.word_size) * rinv % p
        Z = L.limbs_to_int(np.asarray(dd.z, np.int64), cfg.word_size) * rinv % p
        zi = pow(Z, -1, p)
        assert (X * zi % p, Y * zi % p) == cv.to_affine(gg), mode
        # post-renorm limb magnitudes stay within a small multiple of the
        # radix (2^w) — 4x headroom below the invariant's working bound,
        # far below the int32 overflow the pre-fix chain reached
        for a in (dd.x, dd.y, dd.z):
            bound = 1 << (cfg.word_size + 2)
            assert int(np.abs(np.asarray(a)).max()) < bound, (
                mode, curve_name, chunk,
            )
