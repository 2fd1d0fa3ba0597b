"""The XLA stages that replaced the first hardware target's kernels, each
against an independent reference: the device Horner ladder vs the exact
python-int Horner, bucket ends vs numpy, and the convert + pack of the
point table vs python-int Montgomery conversion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from msm_tpu.models import common, cuzk
from msm_tpu.ops import scan
from msm_tpu.ops.curve import PointBatch, get_curve_ctx
from msm_tpu.ops.packing import coord_words
from msm_tpu.oracle.pyecc import Curve
from msm_tpu.params import BLS12_381, BN254, PALLAS, MsmConfig

CURVE_PARAMS = pytest.mark.parametrize(
    "curve", [BN254, BLS12_381, PALLAS], ids=lambda c: c.name
)


def _dense_to_int(row: np.ndarray) -> int:
    """[D] int32 dense words -> the packed integer (words are raw u32)."""
    v = 0
    for k, word in enumerate(row.astype(np.int64) & 0xFFFFFFFF):
        v |= int(word) << (32 * k)
    return v


@CURVE_PARAMS
def test_device_horner_matches_host(curve):
    """msm_point_from_ws (the device Horner ladder + export) vs the exact
    python-int Horner over the same Montgomery window sums, with an empty
    (identity) window in the middle."""
    cfg = MsmConfig(curve=curve, chunk_size=8)
    ec = get_curve_ctx(cfg)
    cv = Curve(curve)
    S = cfg.num_subtasks
    aff = [cv.to_affine(p) for p in cv.sample_points(S - 1, seed=9)]
    x_u16, y_u16, _ = common.pad_inputs(aff, [0] * (S - 1), cfg)
    pb = common.u16_to_mont_points(
        ec, jnp.asarray(x_u16)[: S - 1], jnp.asarray(y_u16)[: S - 1]
    )
    ident = ec.identity((1,))
    ws = PointBatch(*(
        jnp.concatenate([a[:3], i, a[3:]])
        for a, i in zip(pb, ident)
    ))
    got_std = jax.jit(lambda w: cuzk.msm_point_from_ws(w, cfg))(
        jnp.stack([ws.x, ws.y, ws.z], axis=1)
    )
    got = common.std_point_to_jpoint(np.asarray(got_std), cfg)
    want = common.window_sums_to_result(
        np.asarray(common.export_points_std(ec, ws)), cfg
    )
    assert cv.eq(got, want)


@pytest.mark.parametrize("skewed", [False, True], ids=["uniform", "skewed"])
def test_bucket_ends_match_numpy(skewed):
    """ends[b] = #{keys <= b} from the sorted keys must equal numpy's
    cumulative bincount exactly — including one bucket holding more than
    4096 keys (a float count path would lose exactness past 2^11 in
    reduced precision) and runs of empty buckets."""
    nb, n = 257, 1 << 14
    rng = np.random.default_rng(17)
    keys = rng.integers(0, nb, size=n).astype(np.int32)
    if skewed:
        keys[: 5000] = 3
        keys[5000:6000] = nb - 1
        keys[(keys > 100) & (keys < 120)] = 7  # empty run 101..119
    ends = jax.jit(
        lambda k: scan.bucket_ends(jnp.sort(k), nb)
    )(jnp.asarray(keys))
    want = np.cumsum(np.bincount(keys, minlength=nb))
    assert (np.asarray(ends) == want).all()


@CURVE_PARAMS
def test_convert_pack_matches_python_ints(curve):
    """prepare_points (word extract + to-Montgomery + canonical dense pack)
    must hold exactly (x*R mod p, y*R mod p) for every point."""
    cfg = MsmConfig(curve=curve)
    ec = get_curve_ctx(cfg)
    cv = Curve(curve)
    n = 64
    aff = [cv.to_affine(p) for p in cv.sample_points(n, seed=7)]
    x_u16, y_u16, _ = common.pad_inputs(aff, [0] * n, cfg)
    table = np.asarray(jax.jit(
        lambda a, b: common.prepare_points(ec, a, b)
    )(jnp.asarray(x_u16)[:n], jnp.asarray(y_u16)[:n]))
    D = coord_words(cfg)
    p = curve.modulus
    assert table.shape == (n, 2 * D)
    for i, (x, y) in enumerate(aff):
        assert _dense_to_int(table[i, :D]) == x * cfg.r % p, i
        assert _dense_to_int(table[i, D:]) == y * cfg.r % p, i
