"""The naive Pippenger MSM pipeline — the de-risking / legacy model.

Plays exactly the role of the reference's ``src/naive/`` path (a
straightforward fixed-window Pippenger used to prove the stack end-to-end
before cuZK; ``naive/wgsl/pippenger.wgsl:10-16`` uses 8-bit unsigned windows,
32 windows x 256 buckets). Unlike the reference's naive path — whose final
reduction kernels were left stubbed (``pippenger.wgsl:57-73``) — this one is
complete and verified.

Shares the sort/scan bucket machinery with the cuZK model; differences:
unsigned digits (no signed recode, so 2^c buckets/window instead of
2^(c-1)+1) and the serial running-sum bucket reduction (one lane per window,
B sequential steps — fine for c=8's 256 buckets).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from msm_tpu.models import common
from msm_tpu.models.geometry import MsmGeometry, pick_geometry
from msm_tpu.ops.curve import PointBatch, get_curve_ctx
from msm_tpu.ops.decompose import extract_windows
from msm_tpu.ops.scan import bucket_accumulate, bucket_reduce_running
from msm_tpu.oracle.pyecc import JPoint
from msm_tpu.params import BN254, MsmConfig


#: 8-bit windows like the reference naive path (naive/wgsl/pippenger.wgsl:10)
NAIVE_CONFIG = MsmConfig(curve=BN254, chunk_size=8)


@functools.partial(jax.jit, static_argnames=("cfg", "geom"))
def naive_window_sums(
    x_u16: jax.Array,
    y_u16: jax.Array,
    s_u16: jax.Array,
    cfg: MsmConfig,
    geom: MsmGeometry,
) -> jax.Array:
    ec = get_curve_ctx(cfg)
    assert not cfg.glv, "GLV runs the cuZK pipeline (models/cuzk.py)"
    table = common.prepare_points(ec, x_u16, y_u16)
    keys = extract_windows(s_u16, cfg.chunk_size, cfg.num_subtasks)  # [S, n]
    num_buckets = 1 << cfg.chunk_size

    def subtask(k):
        buckets = bucket_accumulate(ec, table, k, num_buckets, geom.num_rows)
        w = bucket_reduce_running(ec, buckets)
        return jnp.stack([w.x, w.y, w.z])

    ws_m = jax.lax.map(
        subtask, keys, batch_size=common.subtask_batch(geom, cfg)
    )
    wpts = PointBatch(ws_m[:, 0], ws_m[:, 1], ws_m[:, 2])
    return common.export_points_std(ec, wpts)


def compute_msm_naive(
    points: list[tuple[int, int]],
    scalars: list[int],
    config: MsmConfig = NAIVE_CONFIG,
    geometry: MsmGeometry | None = None,
) -> JPoint:
    """End-to-end naive-path MSM, returns oracle JPoint
    (reference: naive run_webgpu_msm, naive/halo2curves/mod.rs:56-76)."""
    if len(points) == 0:
        from msm_tpu.oracle.pyecc import IDENTITY

        return IDENTITY
    x_u16, y_u16, s_u16 = common.pad_inputs(points, scalars, config)
    n = x_u16.shape[0]
    geom = geometry or pick_geometry(n, config.chunk_size)
    ws = naive_window_sums(
        jnp.asarray(x_u16), jnp.asarray(y_u16), jnp.asarray(s_u16), config, geom
    )
    return common.window_sums_to_result(np.asarray(ws), config)
