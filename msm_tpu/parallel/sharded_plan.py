"""Multi-chip serving plan: a device-SHARDED point table reused across calls.

Composes the two serving-scale features the reference lacks entirely
(single-``wgpu::Device`` library, per-call point upload+convert —
``src/cuzk/gpu.rs:11-23``, ``src/cuzk/msm.rs:75-417``):

- the **serving plan** (``models/plan.py``): the SRS point set is fixed
  across thousands of MSMs, so serialize + convert + pack it ONCE and cache
  the device table; each call ships only packed scalars;
- the **sharded pipeline** (``parallel/sharded.py``): points sharded over a
  ``jax.sharding.Mesh``, stages 1-4 fully local per shard, cross-chip merge
  = ``all_gather`` of the KB-size window sums + a Jacobian point-add tree.

Here the cached table itself is a sharded ``jax.Array`` — each chip holds
(and converts, at build time) only its own point shard — so a multi-device
prover pays the table build once and every subsequent proof runs only the
scalar-side pipeline, compute-local per chip:

    splan = msm_tpu.plan_sharded(points, mesh=mesh)
    xy1   = splan(scalars_1)                 # per call: scalars only
    many  = splan.run_batch([ks_a, ks_b])    # ONE program, shared table

Size scaling composes exactly like the single-device plan: each shard
slices locally at SLICE inside the per-shard body (the stacked per-slice
tables of ``models/plan._chunk_ws_mont``), and point sets beyond
``CHUNK_MAX * D`` split into host-level chunks whose standard-form window
sums merge in exact ints.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from msm_tpu.models import common, cuzk
from msm_tpu.models.geometry import MsmGeometry, pick_geometry
from msm_tpu.models.plan import (
    _chunk_ws_mont,
    _pack_scalar_words_host,
    _unpack_scalar_words,
    scalars_to_words,
)
from msm_tpu.ops.curve import PointBatch, get_curve_ctx
from msm_tpu.oracle.pyecc import Curve, JPoint
from msm_tpu.params import MsmConfig, pick_config
from msm_tpu.parallel.sharded import _tree_add_points, default_mesh


@functools.partial(
    jax.jit, static_argnames=("cfg", "slice_n", "mesh", "axis")
)
def _prepare_tables_sharded(
    x_u16: jax.Array,
    y_u16: jax.Array,
    cfg: MsmConfig,
    slice_n: int,
    mesh: Mesh,
    axis: str,
):
    """Build-time table prep, run ONCE per chunk: globally-[n, W] u16 point
    words sharded over ``mesh[axis]`` -> the per-shard stacked per-slice
    point tables (leading dim = slices per shard), still sharded over the
    mesh. Each chip converts only its own shard — the distributed analogue
    of stage 1 at ``src/cuzk/msm.rs:441-524``."""
    ec = get_curve_ctx(cfg)

    def shard_fn(xs, ys):
        k = xs.shape[0] // slice_n
        xk = xs.reshape(k, slice_n, xs.shape[1])
        yk = ys.reshape(k, slice_n, ys.shape[1])

        def body(args):
            xa, ya = args
            return common.prepare_points(ec, xa, ya)

        if k == 1:
            return body((xk[0], yk[0]))[None]
        return jax.lax.map(body, (xk, yk))

    spec = P(axis, None)
    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=P(axis),
        check_vma=False,
    )(x_u16, y_u16)


@functools.partial(
    jax.jit, static_argnames=("cfg", "geom", "mesh", "axis")
)
def _sharded_plan_ws_std(
    tables, s_packed: jax.Array, cfg: MsmConfig, geom: MsmGeometry,
    mesh: Mesh, axis: str,
) -> jax.Array:
    """Per-call program: sharded cached tables + sharded packed scalar
    words [n, W/2] -> replicated standard-form window sums [S, 3, L]. ONE
    jitted XLA program: local scalar pipeline per shard, then the
    all_gather + point-add-tree merge of ``parallel/sharded.py``."""
    ec = get_curve_ctx(cfg)

    def shard_fn(tab, sp):
        ws_m = _chunk_ws_mont(tab, _unpack_scalar_words(sp), cfg, geom)
        return _tree_add_points(ec, jax.lax.all_gather(ws_m, axis))

    merged_m = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis, None)),
        out_specs=P(),
        check_vma=False,
    )(tables, s_packed)
    return common.export_points_std(
        ec, PointBatch(merged_m[:, 0], merged_m[:, 1], merged_m[:, 2])
    )


@functools.partial(
    jax.jit, static_argnames=("cfg", "geom", "mesh", "axis")
)
def _sharded_plan_ws_std_batched(
    tables, s_packed: jax.Array, cfg: MsmConfig, geom: MsmGeometry,
    mesh: Mesh, axis: str,
) -> jax.Array:
    """Batched per-call program: B packed scalar sets [B, n, W/2] sharing
    the ONE sharded table -> [B, S, 3, L] replicated standard-form window
    sums. Instances run sequentially inside the jit (a single instance's
    scan saturates each chip's lanes, as in ``models/batched.py``)."""
    ec = get_curve_ctx(cfg)

    def shard_fn(tab, sp):
        def one(ss):
            ws_m = _chunk_ws_mont(tab, _unpack_scalar_words(ss), cfg, geom)
            return _tree_add_points(ec, jax.lax.all_gather(ws_m, axis))

        return jax.lax.map(one, sp, batch_size=1)

    merged_m = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P(None, axis, None)),
        out_specs=P(),
        check_vma=False,
    )(tables, s_packed)

    def export(ws):
        return common.export_points_std(
            ec, PointBatch(ws[:, 0], ws[:, 1], ws[:, 2])
        )

    return jax.lax.map(export, merged_m, batch_size=1)


class ShardedMsmPlan:
    """A reusable multi-chip MSM over a fixed, device-sharded point set.
    Build with ``msm_tpu.plan_sharded`` (see module docstring)."""

    def __init__(
        self,
        points: list[tuple[int, int]],
        mesh: Mesh | None = None,
        config: MsmConfig | None = None,
        geometry: MsmGeometry | None = None,
        validate: bool = False,
    ):
        n = len(points)
        assert n > 0, "plan requires a non-empty point set"
        self.mesh = mesh or default_mesh()
        self.axis = self.mesh.axis_names[0]
        d = self.mesh.devices.size
        if d & (d - 1):
            raise ValueError(f"device count {d} must be a power of two")
        self.cfg = config or pick_config(n)
        if validate:
            common.validate_inputs(points, [], self.cfg)
        self.n = n
        # equal power-of-two slice per shard (pad_inputs multiple=16*d rule)
        self.N = common.pad_size(max(n, 16 * d))
        x_u16, y_u16 = common.pad_points_words(points, self.cfg, self.N)
        self._chunk_n = min(self.N, cuzk.CHUNK_MAX * d)
        shard_n = self._chunk_n // d
        slice_n = min(shard_n, cuzk.SLICE)
        self.geom = geometry or pick_geometry(slice_n, self.cfg.chunk_size)
        self._sharding = NamedSharding(self.mesh, P(self.axis, None))
        self._tables = []
        for lo in range(0, self.N, self._chunk_n):
            xd = jax.device_put(
                jnp.asarray(x_u16[lo : lo + self._chunk_n]), self._sharding
            )
            yd = jax.device_put(
                jnp.asarray(y_u16[lo : lo + self._chunk_n]), self._sharding
            )
            self._tables.append(
                _prepare_tables_sharded(
                    xd, yd, self.cfg, slice_n, self.mesh, self.axis
                )
            )

    def _put_scalars(self, sp: np.ndarray, batched: bool) -> jax.Array:
        spec = P(None, self.axis, None) if batched else P(self.axis, None)
        return jax.device_put(sp, NamedSharding(self.mesh, spec))

    def jpoint(self, scalars) -> JPoint:
        """Run the plan over one scalar set -> oracle JPoint."""
        s_all = scalars_to_words(scalars, self.cfg, self.n, self.N)
        cv = Curve(self.cfg.curve)
        acc = None
        for tab, lo in zip(self._tables, range(0, self.N, self._chunk_n)):
            sd = self._put_scalars(
                _pack_scalar_words_host(s_all[lo : lo + self._chunk_n]),
                batched=False,
            )
            ws = _sharded_plan_ws_std(
                tab, sd, self.cfg, self.geom, self.mesh, self.axis
            )
            wj = common.window_sums_to_jpoints(np.asarray(ws), self.cfg)
            acc = wj if acc is None else [
                cv.add(a, b) for a, b in zip(acc, wj)
            ]
        return common.horner_window_sums(acc, self.cfg)

    def __call__(self, scalars) -> tuple[int, int] | None:
        """Run the plan -> affine (x, y), or None for the identity."""
        return common.result_to_affine(self.jpoint(scalars), self.cfg)

    def run_batch(self, scalar_sets) -> list[JPoint]:
        """Run B scalar sets as ONE device program per chunk, all sharing
        the cached sharded table."""
        if not scalar_sets:
            return []
        s_all = np.stack([
            scalars_to_words(k, self.cfg, self.n, self.N)
            for k in scalar_sets
        ])
        B = s_all.shape[0]
        cv = Curve(self.cfg.curve)
        accs: list[list[JPoint] | None] = [None] * B
        for tab, lo in zip(self._tables, range(0, self.N, self._chunk_n)):
            sd = self._put_scalars(
                _pack_scalar_words_host(
                    s_all[:, lo : lo + self._chunk_n]
                ),
                batched=True,
            )
            ws = _sharded_plan_ws_std_batched(
                tab, sd, self.cfg, self.geom, self.mesh, self.axis
            )
            arr = np.asarray(ws)
            for b in range(B):
                wj = common.window_sums_to_jpoints(arr[b], self.cfg)
                accs[b] = wj if accs[b] is None else [
                    cv.add(a, w) for a, w in zip(accs[b], wj)
                ]
        return [common.horner_window_sums(a, self.cfg) for a in accs]


def plan_sharded(
    points: list[tuple[int, int]],
    mesh: Mesh | None = None,
    config: MsmConfig | None = None,
    geometry: MsmGeometry | None = None,
    validate: bool = False,
) -> ShardedMsmPlan:
    """Prepare a multi-chip MSM plan over a fixed point set (see module
    docstring)."""
    return ShardedMsmPlan(
        points, mesh=mesh, config=config, geometry=geometry,
        validate=validate,
    )
