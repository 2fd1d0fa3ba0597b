"""Shared host<->device plumbing for the MSM pipelines.

The host/device split mirrors the reference's ``compute_msm``
(``src/cuzk/msm.rs:75-417``): the host pads inputs to a power of two, ships
coordinates/scalars as 16x16-bit words (the reference's stage-1 wire format,
``decompose_scalars.template.wgsl:41-53``), the device runs the heavy stages,
and the host finishes with the per-subtask Horner sum in exact integer
arithmetic (reference finishes on CPU the same way, ``msm.rs:391-416``).
The single-chunk production paths run the Horner tail on the device
instead (``cuzk.msm_point_from_ws``) and the host only maps one homogeneous
point to affine.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from msm_tpu.ops.curve import CurveCtx, PointBatch
from msm_tpu.ops.decompose import extract_windows
from msm_tpu.ops.packing import pack_coords
from msm_tpu.oracle.pyecc import Curve, IDENTITY, JPoint
from msm_tpu.params import MsmConfig
from msm_tpu.utils import limbs as L


def subtask_batch(geom, cfg: MsmConfig) -> int:
    """How many subtasks to process concurrently in the lax.map."""
    return min(geom.subtask_batch, cfg.num_subtasks)


def pad_size(n: int) -> int:
    """Next power of two >= max(n, 16) (reference pads to pow2,
    msm.rs:48-61)."""
    n = max(n, 16)
    return 1 << (n - 1).bit_length()


def ints_to_u16_array(xs: list[int], nbytes: int = 32) -> np.ndarray:
    """Fast path: python ints -> [n, nbytes/2] uint16-in-int32 array."""
    buf = b"".join(x.to_bytes(nbytes, "little") for x in xs)
    return (
        np.frombuffer(buf, dtype="<u2").reshape(len(xs), nbytes // 2)
        .astype(np.int32)
    )


def validate_inputs(
    points: list[tuple[int, int]],
    scalars: list[int],
    cfg: MsmConfig,
) -> None:
    """Optional input-contract guard (closes the footgun the reference
    closes with halo2curves' typed points, ``src/lib.rs:20-42``): points
    off the curve — or on the curve but outside the prime-order subgroup
    when the cofactor > 1 — silently corrupt the MSM result, because the
    pipeline's group algebra is only a homomorphism on the subgroup.

    Checks, raising ``ValueError`` on the first violation:
    - coordinate range: 0 <= x, y < q
    - curve membership: y^2 == x^3 + a*x + b  (mod q) — one field eval
      per point in exact host integers (~1 us/point)
    - subgroup membership when ``cfg.curve.cofactor > 1``: [r]P == O via
      the VECTORIZED device double-and-add ladder (scalar_mul_static) —
      ~2 x order_bits batched point-ops over the whole batch instead of
      the ~minutes/point a host ladder costs

    ``len(points) == len(scalars)`` is asserted at the pad boundary, not
    here; scalar range needs no check (pad_inputs reduces mod r).
    """
    q = cfg.curve.modulus
    a, b = cfg.curve.a, cfg.curve.b
    for i, (x, y) in enumerate(points):
        if not (0 <= x < q and 0 <= y < q):
            raise ValueError(
                f"point {i} coordinates out of field range [0, q)"
            )
        if (y * y - (x * x * x + a * x + b)) % q != 0:
            raise ValueError(f"point {i} is not on the curve")
    if cfg.curve.cofactor > 1:
        # NB: a "mod r" ladder would make [r]P trivially O — the subgroup
        # test needs the UNREDUCED full-width scalar over the whole curve
        # group, which scalar_mul_static provides (static bit pattern).
        # Generator padding is inert: all shipped generators are subgroup
        # members, so padded lanes always pass.
        n = len(points)
        x_u16, y_u16 = pad_points_words(points, cfg, pad_size(n))
        mask = np.asarray(
            subgroup_mask_device(
                jnp.asarray(x_u16), jnp.asarray(y_u16), cfg
            )
        )
        bad = np.flatnonzero(~mask[:n])
        if bad.size:
            raise ValueError(
                f"point {int(bad[0])} is outside the prime-order subgroup "
                f"(cofactor {cfg.curve.cofactor})"
            )


@functools.partial(jax.jit, static_argnames=("cfg",))
def _subgroup_mask_jit(x_u16, y_u16, *, cfg: MsmConfig):
    from msm_tpu.ops.curve import get_curve_ctx

    ec = get_curve_ctx(cfg)
    pts = u16_to_mont_points(ec, x_u16, y_u16)
    return ec.is_identity(ec.scalar_mul_static(pts, cfg.curve.order))


def subgroup_mask_device(
    x_u16: jax.Array, y_u16: jax.Array, cfg: MsmConfig
) -> jax.Array:
    """Per-point prime-order-subgroup membership: [r]P == O, as one jitted
    device program over the whole batch (the fast subgroup check the
    reference gets statically from halo2curves' typed points,
    ``src/lib.rs:20-42``). Input: padded u16-word coordinates [N, W]."""
    return _subgroup_mask_jit(x_u16, y_u16, cfg=cfg)


def pad_inputs(
    points: list[tuple[int, int]],
    scalars: list[int],
    cfg: MsmConfig,
    multiple: int = 1,
    validate: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad to a power of two with zero scalars + generator points (zero
    digits land in bucket 0, whose multiplier is 0 — inert in both pipelines;
    the reference instead pads with +-cancelling random pairs, msm.rs:48-61)
    and serialize to u16-word arrays. ``multiple`` raises the floor so every
    mesh shard gets an equal power-of-two slice (sharded path)."""
    n = len(points)
    assert n == len(scalars)
    if validate:
        validate_inputs(points, scalars, cfg)
    N = pad_size(max(n, multiple))
    x_u16, y_u16 = pad_points_words(points, cfg, N)
    return x_u16, y_u16, pad_scalars_words(scalars, cfg, N)


def pad_points_words(
    points: list[tuple[int, int]], cfg: MsmConfig, N: int
) -> tuple[np.ndarray, np.ndarray]:
    """Points half of ``pad_inputs``: pad to N with the generator and
    serialize to u16-word arrays. Split out for the serving plan API,
    which serializes points ONCE and scalars per call."""
    n = len(points)
    gx, gy = cfg.curve.gx % cfg.curve.modulus, cfg.curve.gy % cfg.curve.modulus
    px = [p[0] for p in points] + [gx] * (N - n)
    py = [p[1] for p in points] + [gy] * (N - n)
    cb = (cfg.curve.modulus_bits + 7) // 8
    cb = max(cb, 2)
    return ints_to_u16_array(px, cb), ints_to_u16_array(py, cb)


def pad_scalars_words(
    scalars: list[int], cfg: MsmConfig, N: int
) -> np.ndarray:
    """Scalars half of ``pad_inputs``: pad to N with zero scalars (zero
    digits land in bucket 0, whose multiplier is 0 — inert in both
    pipelines; the reference instead pads with +-cancelling random pairs,
    msm.rs:48-61) and serialize to a u16-word array.

    Scalar domain: the signed-window geometry proves its top-digit bound
    only for k < order (the reference's Fr type enforces this statically,
    lib.rs:20-24; a raw out-of-range int here would overflow the top
    bucket index SILENTLY). Reduce only when violated — the common case
    pays one compare per scalar, not a bigint mod. Contract note: like
    the reference, points must lie in the prime-order subgroup (all
    shipped G1 generators do); k = k mod order is only an identity
    there, so cofactor>1 curve points OUTSIDE the subgroup are
    out-of-contract either way."""
    n = len(scalars)
    ks = list(scalars)
    order = cfg.curve.order
    if any(k < 0 or k >= order for k in ks):
        ks = [k % order for k in ks]
    ks = ks + [0] * (N - n)
    nb = (cfg.scalar_bits + 7) // 8
    return ints_to_u16_array(ks, nb)


def pack_points(pts: PointBatch, cfg) -> jax.Array:
    """Dense-pack the affine x||y coordinates (packing.pack_coords,
    canonical radix-2^32 rows) — the point-table row format the scan
    gathers from; computed once per MSM, reused per subtask."""
    return jnp.concatenate(
        [pack_coords(pts.x, cfg), pack_coords(pts.y, cfg)], axis=-1
    )


def prepare_points(
    ec: CurveCtx, x_u16: jax.Array, y_u16: jax.Array
) -> jax.Array:
    """Stage-1 point preparation, once per MSM (or once per plan): word
    extraction + to-Montgomery + dense packing -> the point table [n, W].

    Rows are (x*R, y*R) with W = 2D; under GLV (cfg.glv) they are the
    TRIPLE rows (x*R, beta*x*R, y*R) with W = 3D, and the scan selects x
    vs beta*x per element by the phi bit riding the sort payload — the
    table stays n rows instead of a doubled 2n-row table."""
    cfg = ec.cfg
    pts = u16_to_mont_points(ec, x_u16, y_u16)
    if not cfg.glv:
        return pack_points(pts, cfg)
    from msm_tpu.ops.glv import glv_params
    from msm_tpu.utils.limbs import int_to_limbs

    mont_beta = (glv_params(cfg.curve).beta * cfg.r) % cfg.curve.modulus
    bl = int_to_limbs(mont_beta, cfg.word_size, cfg.num_words).astype(np.int32)
    phix = ec.f.mont_mul(pts.x, bl)
    return jnp.concatenate(
        [
            pack_coords(pts.x, cfg),
            pack_coords(phix, cfg),
            pack_coords(pts.y, cfg),
        ],
        axis=-1,
    )


def u16_to_mont_points(
    ec: CurveCtx, x_u16: jax.Array, y_u16: jax.Array
) -> PointBatch:
    """Device-side stage-1 point conversion: 16-bit words -> word_size-bit
    limbs -> Montgomery form (decompose_scalars.template.wgsl:56-70)."""
    cfg = ec.cfg
    xs = extract_windows(x_u16, cfg.word_size, cfg.num_words).T  # [n, L]
    ys = extract_windows(y_u16, cfg.word_size, cfg.num_words).T
    xm = ec.f.to_mont(xs)
    ym = ec.f.to_mont(ys)
    return ec.from_affine_mont(xm, ym)


def export_points_std(ec: CurveCtx, pts: PointBatch) -> jax.Array:
    """Montgomery projective [S] batch -> standard-form limbs [S, 3, L]
    (device-side from-Montgomery, the analogue of the host *rinv pass at
    msm.rs:354-380)."""
    f = ec.f
    xyz = jnp.stack([pts.x, pts.y, pts.z], axis=-2)  # [..., 3, L]
    return f.canonical(f.from_mont(xyz))


def std_point_to_jpoint(pt_std: np.ndarray, cfg: MsmConfig) -> JPoint:
    """[3, L] standard-form homogeneous limb triple -> oracle JPoint (the
    host tail of the device-Horner path: one modular inversion)."""
    p = cfg.curve.modulus
    arr = np.asarray(pt_std)
    x = L.limbs_to_int(arr[0], cfg.word_size)
    y = L.limbs_to_int(arr[1], cfg.word_size)
    z = L.limbs_to_int(arr[2], cfg.word_size)
    if z == 0:
        return IDENTITY
    zi = pow(z, -1, p)
    return Curve(cfg.curve).from_affine(x * zi % p, y * zi % p)


def window_sums_to_jpoints(
    window_sums_std: np.ndarray, cfg: MsmConfig
) -> list[JPoint]:
    """[S, 3, L] standard-form homogeneous limb triples -> oracle JPoints."""
    cv = Curve(cfg.curve)
    p = cfg.curve.modulus
    ws = []
    arr = np.asarray(window_sums_std)
    for t in range(arr.shape[0]):
        x = L.limbs_to_int(arr[t, 0], cfg.word_size)
        y = L.limbs_to_int(arr[t, 1], cfg.word_size)
        z = L.limbs_to_int(arr[t, 2], cfg.word_size)
        if z == 0:
            ws.append(IDENTITY)
        else:
            zi = pow(z, -1, p)  # homogeneous: affine = (x/z, y/z)
            ws.append(cv.from_affine(x * zi % p, y * zi % p))
    return ws


def horner_window_sums(ws: list[JPoint], cfg: MsmConfig) -> JPoint:
    """Horner over per-subtask window sums (msm.rs:409-416), exact ints."""
    cv = Curve(cfg.curve)
    acc = ws[-1]
    for wpt in reversed(ws[:-1]):
        for _ in range(cfg.chunk_size):
            acc = cv.double(acc)
        acc = cv.add(acc, wpt)
    return acc


def window_sums_to_result(
    window_sums_std: np.ndarray, cfg: MsmConfig
) -> JPoint:
    """Host finalization: Horner over the per-subtask window sums in exact
    python-int arithmetic (msm.rs:409-416). Input [S, 3, L] standard-form
    limbs of homogeneous projective points."""
    return horner_window_sums(
        window_sums_to_jpoints(window_sums_std, cfg), cfg
    )


def result_to_affine(res: JPoint, cfg: MsmConfig):
    """JPoint -> affine (x, y) ints, or None for the identity."""
    if res.is_identity():
        return None
    return Curve(cfg.curve).to_affine(res)
