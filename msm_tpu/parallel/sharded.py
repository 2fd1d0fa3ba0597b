"""Multi-chip sharded MSM — the distributed layer the reference lacks.

The reference is a single-`wgpu::Device` library (``src/cuzk/gpu.rs:11-23``);
its only data movement is host<->GPU buffer traffic. The scaling story
(SURVEY §2.5, §5) shards the big axis — the n points / scalars — across
a `jax.sharding.Mesh`:

- stages 1-4 (decompose, sort-transpose, bucket scan, bucket reduce) run
  **entirely locally** on each chip's point shard: a partial MSM of the shard
  is a valid MSM, and window sums add in the group;
- the cross-chip merge reduces per-chip window sums [S, 3, L] with a
  **Jacobian point-add tree** — NOT a `psum` (point addition is nonlinear in
  limb space). With the complete projective formulas the identity is a true
  neutral element, so the tree needs no masking. Window sums are tiny
  (16 x 3 x 20 int32 ≈ 4 KB), so one `all_gather` (NCCL over NVLink on
  GPUs) + a local log2(D)-depth tree-add is bandwidth-trivial; compute
  stays fully local.

Multi-host runs ride the same code path: `jax.distributed.initialize()` +
a global mesh makes `shard_map` treat cross-host hops identically (the
all-gathered payload is KBs, so network latency is immaterial next to the
local scan work).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from msm_tpu.models import common
from msm_tpu.models import cuzk as _cuzk
from msm_tpu.models.geometry import MsmGeometry, pick_geometry
from msm_tpu.ops.curve import PointBatch, get_curve_ctx
from msm_tpu.oracle.pyecc import JPoint
from msm_tpu.params import DEFAULT_CONFIG, MsmConfig


def default_mesh(devices=None, axis: str = "data") -> Mesh:
    """1-D mesh over all (or the given) devices."""
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.asarray(devices), (axis,))


def _tree_add_points(ec, stacked: jax.Array) -> jax.Array:
    """[D, S, 3, L] stacked window-sum tensors -> [S, 3, L] point-added over
    axis 0 (log2(D) unrolled tree; D is static and small)."""
    d = stacked.shape[0]
    while d > 1:
        half = d // 2
        a = PointBatch(stacked[:half, :, 0], stacked[:half, :, 1], stacked[:half, :, 2])
        b = PointBatch(stacked[half : 2 * half, :, 0], stacked[half : 2 * half, :, 1],
                       stacked[half : 2 * half, :, 2])
        s = ec.add(a, b)
        merged = jnp.stack([s.x, s.y, s.z], axis=-2)  # [half, S, 3, L]
        if d % 2:
            merged = jnp.concatenate([merged, stacked[2 * half : d]], axis=0)
        stacked = merged
        d = stacked.shape[0]
    return stacked[0]


#: Single-shard cuZK stages 1-4: u16 inputs [m, 16] -> Montgomery window
#: sums [S, 3, L]. This IS the production single-chip body
#: (models.cuzk._window_sums_all — packed-table scan, telescoped reduction,
#: INCLUDING the n > SLICE per-slice composition, so a shard larger than
#: 2^20 slices locally exactly like the single-chip path): one pipeline,
#: whether sharded or not, exactly like the reference's single
#: command-buffer submit covering every stage (src/cuzk/msm.rs:92-94).
def _local_window_sums(x, y, s, cfg, geom):
    return _cuzk._window_sums_all(x, y, s, cfg, geom)


@functools.partial(
    jax.jit, static_argnames=("cfg", "geom", "mesh", "axis")
)
def sharded_window_sums(
    x_u16: jax.Array,
    y_u16: jax.Array,
    s_u16: jax.Array,
    cfg: MsmConfig,
    geom: MsmGeometry,
    mesh: Mesh,
    axis: str = "data",
) -> jax.Array:
    """Full sharded device pipeline: globally-[n, 16] u16 inputs, point axis
    sharded over ``mesh[axis]`` -> replicated [S, 3, L] standard-form window
    sums. ONE jitted XLA program including the cross-chip point-add merge."""
    ec = get_curve_ctx(cfg)

    def shard_fn(x, y, s):
        ws_m = _local_window_sums(x, y, s, cfg, geom)  # [S, 3, L] local
        allws = jax.lax.all_gather(ws_m, axis)  # [D, S, 3, L]
        return _tree_add_points(ec, allws)  # replicated [S, 3, L]

    spec = P(axis, None)
    merged_m = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=P(),
        check_vma=False,
    )(x_u16, y_u16, s_u16)
    wpts = PointBatch(merged_m[:, 0], merged_m[:, 1], merged_m[:, 2])
    return common.export_points_std(ec, wpts)


def compute_msm_sharded(
    points: list[tuple[int, int]],
    scalars: list[int],
    config: MsmConfig = DEFAULT_CONFIG,
    mesh: Mesh | None = None,
    geometry: MsmGeometry | None = None,
) -> JPoint:
    """End-to-end multi-chip MSM (host API). Pads n so every shard is an
    equal power-of-two slice, ships sharded arrays, finishes with the exact
    host Horner like the single-chip path."""
    if len(points) == 0:
        from msm_tpu.oracle.pyecc import IDENTITY

        return IDENTITY
    mesh = mesh or default_mesh()
    axis = mesh.axis_names[0]
    d = mesh.devices.size
    if d & (d - 1):
        raise ValueError(f"device count {d} must be a power of two")
    x_u16, y_u16, s_u16 = common.pad_inputs(
        points, scalars, config, multiple=16 * d
    )
    n = x_u16.shape[0]
    # size scaling composes with sharding exactly like single-chip
    # (SURVEY §5 "input-size scaling x sharding"): shards larger than
    # SLICE slice inside the shard_map program (_window_sums_all), and
    # shards larger than CHUNK_MAX run host-level chunks of d*CHUNK_MAX
    # global points whose window sums merge in exact ints
    geom = geometry or pick_geometry(
        min(n // d, _cuzk.SLICE), config.chunk_size
    )
    sharding = NamedSharding(mesh, P(axis, None))
    chunk_global = _cuzk.CHUNK_MAX * d
    if n <= chunk_global:
        xd = jax.device_put(jnp.asarray(x_u16), sharding)
        yd = jax.device_put(jnp.asarray(y_u16), sharding)
        sd = jax.device_put(jnp.asarray(s_u16), sharding)
        ws = sharded_window_sums(xd, yd, sd, config, geom, mesh, axis)
        return common.window_sums_to_result(np.asarray(ws), config)
    from msm_tpu.oracle.pyecc import Curve

    assert n % chunk_global == 0, (n, chunk_global)
    cv = Curve(config.curve)
    acc = None
    for lo in range(0, n, chunk_global):
        xd = jax.device_put(
            jnp.asarray(x_u16[lo : lo + chunk_global]), sharding
        )
        yd = jax.device_put(
            jnp.asarray(y_u16[lo : lo + chunk_global]), sharding
        )
        sd = jax.device_put(
            jnp.asarray(s_u16[lo : lo + chunk_global]), sharding
        )
        ws = sharded_window_sums(xd, yd, sd, config, geom, mesh, axis)
        wj = common.window_sums_to_jpoints(np.asarray(ws), config)
        acc = wj if acc is None else [cv.add(a, b) for a, b in zip(acc, wj)]
    return common.horner_window_sums(acc, config)
