"""The cuZK MSM pipeline — the production model.

Re-design of the reference's 4-stage GPU pipeline
(``src/cuzk/msm.rs:75-417``) as one XLA program:

  stage 1  convert + decompose  -> vectorized limb extraction + to-Montgomery
                                   + signed window recode (ops/decompose.py)
  stage 2  sparse transpose     -> lax.sort_key_val by bucket key
  stage 3  SMVP                 -> blocked prefix point-scan + boundary
                                   prefix-differences (ops/scan.py)
  stage 4  BPR                  -> telescoped window sums straight from
                                   the boundary prefixes (ops/scan.py)
  finish   per-subtask Horner   -> device ladder; the host maps the one
                                   resulting point to affine

Everything between the u16-word inputs and the [S, 3, L] window-sum output is
ONE jitted XLA program per (config, n) — jax.jit plays the role the WGSL
shader compiler + command-encoder submission play in the reference
(single submit for all stages, gpu.rs:119-121).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from msm_tpu.models import common
from msm_tpu.models.geometry import MsmGeometry, pick_geometry
from msm_tpu.ops.curve import CurveCtx, PointBatch, get_curve_ctx
from msm_tpu.ops.decompose import decompose_signed
from msm_tpu.ops.scan import bucket_boundary_prefix, window_sum_from_pe
from msm_tpu.oracle.pyecc import JPoint
from msm_tpu.params import DEFAULT_CONFIG, MsmConfig


#: slice size for large MSMs: window sums are linear in the points, so
#: n > SLICE runs as SLICE-point slices whose Montgomery window sums are
#: point-added before export. Not yet tuned on the H100.
SLICE = 1 << 20

#: device program cap: above it compute_msm_jpoint runs host-level chunks
#: whose window sums merge with ~S exact point adds each. Module-level so
#: tests can shrink it to exercise the chunked branch at small n. Not yet
#: tuned on the H100.
CHUNK_MAX = 1 << 22


def _window_sums_mont(
    x_u16: jax.Array,
    y_u16: jax.Array,
    s_u16: jax.Array,
    cfg: MsmConfig,
    geom: MsmGeometry,
) -> jax.Array:
    """One slice: u16-word inputs [n, 16] -> Montgomery window sums
    [S, 3, L] (stacked PointBatch coordinates)."""
    ec = get_curve_ctx(cfg)
    table = common.prepare_points(ec, x_u16, y_u16)
    return window_sums_from_table(table, s_u16, cfg, geom)


def window_sums_from_table(
    table: jax.Array,
    s_u16: jax.Array,
    cfg: MsmConfig,
    geom: MsmGeometry,
) -> jax.Array:
    """Scalar-side pipeline body (stages 1b-4) with the packed point table
    already prepared (``common.prepare_points``): signed decompose +
    per-subtask boundary scans + telescoped reduction -> Montgomery window
    sums [S, 3, L]. Split out so the serving plan API (models/plan.py) can
    cache the table across many scalar sets."""
    ec = get_curve_ctx(cfg)
    if cfg.glv:
        # GLV: 2n logical points (P, phi(P)), half-length scalars -> half
        # the subtasks; keys/signs columns n..2n-1 address the phi column
        from msm_tpu.ops.glv import decompose_signed_glv

        keys, signs = decompose_signed_glv(
            s_u16, cfg.chunk_size, cfg.num_subtasks, cfg
        )
    else:
        keys, signs = decompose_signed(
            s_u16, cfg.chunk_size, cfg.num_subtasks
        )

    def subtask(args):
        k, s = args
        pe = bucket_boundary_prefix(
            ec, table, k, cfg.num_buckets, geom.num_rows, signs=s
        )
        return jnp.stack([pe.x, pe.y, pe.z])

    bk = jax.lax.map(
        subtask, (keys, signs), batch_size=common.subtask_batch(geom, cfg)
    )  # [S, 3, NB, L] Montgomery boundary prefixes
    # telescoped bucket reduction over ALL subtasks at once: W is computed
    # straight from the boundary prefixes (window_sum_from_pe), so neither
    # the per-bucket differences nor the two-phase BPR run in production
    pe16 = PointBatch(bk[:, 0], bk[:, 1], bk[:, 2])
    w = jax.vmap(lambda p: window_sum_from_pe(ec, p))(pe16)
    return jnp.stack([w.x, w.y, w.z], axis=1)  # [S, 3, L]


@functools.partial(jax.jit, static_argnames=("cfg", "geom"))
def cuzk_msm_point(
    x_u16: jax.Array,
    y_u16: jax.Array,
    s_u16: jax.Array,
    cfg: MsmConfig,
    geom: MsmGeometry,
) -> jax.Array:
    """Full device MSM: u16-word inputs -> ONE standard-form projective
    point [3, L] (window sums + the device Horner ladder); the host only
    maps the single homogeneous triple to affine."""
    ws = _window_sums_all(x_u16, y_u16, s_u16, cfg, geom)
    return msm_point_from_ws(ws, cfg)


def horner_ladder(ec: CurveCtx, ws: PointBatch, chunk: int) -> PointBatch:
    """Horner over per-subtask window sums [S] on the device:
    acc = W_{S-1}; acc = 2^chunk * acc + W_i for i = S-2 .. 0 — the device
    twin of ``common.horner_window_sums`` (msm.rs:409-416)."""
    S = ws.x.shape[0]

    def body(i, acc):
        acc = jax.lax.fori_loop(0, chunk, lambda _, a: ec.double(a), acc)
        j = S - 2 - i
        return ec.add(acc, PointBatch(ws.x[j], ws.y[j], ws.z[j]))

    top = PointBatch(ws.x[S - 1], ws.y[S - 1], ws.z[S - 1])
    return jax.lax.fori_loop(0, S - 1, body, top)


def msm_point_from_ws(ws: jax.Array, cfg: MsmConfig) -> jax.Array:
    """Montgomery window sums [S, 3, L] -> ONE standard-form projective
    point [3, L] (device Horner ladder + from-Montgomery export)."""
    ec = get_curve_ctx(cfg)
    acc = horner_ladder(
        ec, PointBatch(ws[:, 0], ws[:, 1], ws[:, 2]), cfg.chunk_size
    )
    acc = PointBatch(acc.x[None], acc.y[None], acc.z[None])
    return common.export_points_std(ec, acc)[0]


@functools.partial(
    jax.jit, static_argnames=("cfg", "geom")
)
def cuzk_window_sums(
    x_u16: jax.Array,
    y_u16: jax.Array,
    s_u16: jax.Array,
    cfg: MsmConfig,
    geom: MsmGeometry,
) -> jax.Array:
    """Device pipeline: u16-word inputs [n, 16] -> window sums [S, 3, L]
    (standard-form projective limbs). n > SLICE runs the pipeline per
    SLICE-point slice under one lax.map (buffers are reused across slices)
    and merges the slice window sums with point adds; ``geom`` applies to
    the per-slice pipeline geometry in that case."""
    ec = get_curve_ctx(cfg)
    ws = _window_sums_all(x_u16, y_u16, s_u16, cfg, geom)
    w = PointBatch(ws[:, 0], ws[:, 1], ws[:, 2])
    return common.export_points_std(ec, w)


def _window_sums_all(
    x_u16: jax.Array,
    y_u16: jax.Array,
    s_u16: jax.Array,
    cfg: MsmConfig,
    geom: MsmGeometry,
) -> jax.Array:
    """Shared body of cuzk_window_sums/cuzk_msm_point: Montgomery window
    sums [S, 3, L] with the n > SLICE slice-and-merge handling."""
    ec = get_curve_ctx(cfg)
    n = x_u16.shape[0]
    if n <= SLICE:
        ws = _window_sums_mont(x_u16, y_u16, s_u16, cfg, geom)
    else:
        assert n % SLICE == 0, (n, SLICE)
        k = n // SLICE
        gs = pick_geometry(SLICE, cfg.chunk_size)

        def body(args):
            xs, ys, ss = args
            return _window_sums_mont(xs, ys, ss, cfg, gs)

        wk = jax.lax.map(
            body,
            (
                x_u16.reshape(k, SLICE, -1),
                y_u16.reshape(k, SLICE, -1),
                s_u16.reshape(k, SLICE, -1),
            ),
        )  # [k, S, 3, L]
        acc = PointBatch(wk[0, :, 0], wk[0, :, 1], wk[0, :, 2])
        for i in range(1, k):
            acc = ec.add(
                acc, PointBatch(wk[i, :, 0], wk[i, :, 1], wk[i, :, 2])
            )
        ws = jnp.stack([acc.x, acc.y, acc.z], axis=1)
    return ws


def compute_msm(
    points: list[tuple[int, int]],
    scalars: list[int],
    config: MsmConfig | None = None,
    geometry: MsmGeometry | None = None,
    validate: bool = False,
) -> tuple[int, int] | None:
    """End-to-end MSM: affine int points + int scalars -> affine (x, y) or
    None for identity. The reference equivalent is compute_msm
    (msm.rs:75-417) behind run_webgpu_msm (lib.rs:76-82).
    ``validate=True`` rejects off-curve / out-of-subgroup points up front
    (common.validate_inputs) instead of silently corrupting the result."""
    from msm_tpu.params import pick_config

    config = config or pick_config(len(points))
    res = compute_msm_jpoint(
        points, scalars, config, geometry, validate=validate
    )
    return common.result_to_affine(res, config)


def compute_msm_jpoint(
    points: list[tuple[int, int]],
    scalars: list[int],
    config: MsmConfig | None = None,
    geometry: MsmGeometry | None = None,
    validate: bool = False,
) -> JPoint:
    """Like compute_msm but returns the oracle JPoint (test convenience)."""
    from msm_tpu.params import pick_config

    config = config or pick_config(len(points))
    if len(points) == 0:
        from msm_tpu.oracle.pyecc import IDENTITY

        return IDENTITY
    x_u16, y_u16, s_u16 = common.pad_inputs(
        points, scalars, config, validate=validate
    )
    n = x_u16.shape[0]
    if n <= CHUNK_MAX:
        geom = geometry or pick_geometry(n, config.chunk_size)
        pt = cuzk_msm_point(
            jax.device_put(x_u16), jax.device_put(y_u16),
            jax.device_put(s_u16), config, geom,
        )
        return common.std_point_to_jpoint(np.asarray(pt), config)
    from msm_tpu.oracle.pyecc import Curve

    cv = Curve(config.curve)
    geom = geometry or pick_geometry(CHUNK_MAX, config.chunk_size)
    acc: list | None = None
    for lo in range(0, n, CHUNK_MAX):
        ws = cuzk_window_sums(
            jax.device_put(x_u16[lo : lo + CHUNK_MAX]),
            jax.device_put(y_u16[lo : lo + CHUNK_MAX]),
            jax.device_put(s_u16[lo : lo + CHUNK_MAX]),
            config, geom,
        )
        wj = common.window_sums_to_jpoints(np.asarray(ws), config)
        acc = wj if acc is None else [cv.add(a, b) for a, b in zip(acc, wj)]
    return common.horner_window_sums(acc, config)
