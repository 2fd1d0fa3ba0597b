"""Serving plan API: prepare the point table once, run many scalar sets.

Real prover workloads fix the point set (the SRS) across thousands of MSMs
while only the scalars change. The reference has no equivalent — every
``compute_msm`` call re-serializes and re-uploads the full point set and
re-runs point conversion on the GPU (``src/cuzk/msm.rs:75-417``, stage 1 at
``msm.rs:441-524``). Here:

    plan = msm_tpu.plan(points)        # once: serialize + device convert/pack
    res1 = plan(scalars_1)             # per call: scalar-side pipeline only
    res2 = plan(scalars_2)
    many = plan.run_batch([ks_a, ks_b, ...])   # B instances, ONE device
                                               # program sharing ONE table

What the plan caches on device (per SLICE-point slice, stacked per chunk):
the packed coordinate table (``common.prepare_points``: canonical
radix-2^32 rows — 64 B/point for BN254). Per call, only the padded scalar
words ship to the device, and the program runs decompose -> sort -> scan ->
telescoped reduction -> device Horner (``cuzk.window_sums_from_table``).

This saves the point conversion and the host point serialization on every
call after the first. ``run_batch`` additionally shares one table across
instances where ``models/batched.py`` ships B input copies, so the batch
width is not capped by B copies of the point inputs.

Size scaling composes exactly like ``compute_msm_jpoint``: n > SLICE runs
per-slice tables under one ``lax.map`` (merged with ~S point adds); n >
CHUNK_MAX splits into host-level chunks whose standard-form window sums
merge in exact ints.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from msm_tpu.models import common, cuzk
from msm_tpu.models.geometry import MsmGeometry, pick_geometry
from msm_tpu.ops.curve import PointBatch, get_curve_ctx
from msm_tpu.oracle.pyecc import Curve, JPoint
from msm_tpu.params import MsmConfig, pick_config


def _pack_scalar_words_host(s_all: np.ndarray) -> np.ndarray:
    """[N, W] u16-in-int32 scalar words -> [N, W/2] packed int32 pairs.
    Halves the per-call host->device scalar transfer, the only per-call
    upload the plan pays."""
    assert s_all.shape[-1] % 2 == 0, s_all.shape
    return s_all[..., 0::2] | (s_all[..., 1::2] << 16)


def scalars_to_words(scalars, cfg: MsmConfig, n: int, N: int) -> np.ndarray:
    """Scalars -> padded u16-word array [N, W]. Accepts a list of ints
    (host-serialized with the out-of-range reduction of ``pad_inputs``)
    or a pre-packed word array of shape [n, W] / [N, W] (int dtype,
    little-endian 16-bit words; caller guarantees k < order — the fast
    serving path that skips python-int serialization entirely). Shared by
    the single-device (``MsmPlan``) and multi-chip
    (``parallel.sharded_plan.ShardedMsmPlan``) serving plans."""
    nb = (cfg.scalar_bits + 7) // 8
    W = nb // 2
    if isinstance(scalars, np.ndarray):
        assert scalars.ndim == 2 and scalars.shape[1] == W, (
            f"expected scalar words [n, {W}], got {scalars.shape}"
        )
        assert scalars.shape[0] in (n, N), (
            f"expected {n} (or padded {N}) scalars, got "
            f"{scalars.shape[0]}"
        )
        out = np.zeros((N, W), np.int32)
        out[: scalars.shape[0]] = scalars
        return out
    assert len(scalars) == n, (
        f"plan built over {n} points, got {len(scalars)} scalars"
    )
    return common.pad_scalars_words(list(scalars), cfg, N)


def _unpack_scalar_words(s_packed: jax.Array) -> jax.Array:
    """In-jit inverse of _pack_scalar_words_host: [..., W/2] -> [..., W]."""
    lo = s_packed & 0xFFFF
    hi = (s_packed >> 16) & 0xFFFF
    return jnp.stack([lo, hi], axis=-1).reshape(*s_packed.shape[:-1], -1)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _prepare_table(x_u16: jax.Array, y_u16: jax.Array, cfg: MsmConfig):
    """One slice's packed point table: the device half of stage 1
    (convert + pack), run once at plan construction."""
    return common.prepare_points(get_curve_ctx(cfg), x_u16, y_u16)


def _chunk_ws_mont(tables, s_words, cfg, geom):
    """One chunk: stacked per-slice tables [k, ...] + scalar words
    [k*R, W] -> Montgomery window sums [S, 3, L] (slices merged with ~S
    point adds, mirroring ``cuzk._window_sums_all``)."""
    ec = get_curve_ctx(cfg)
    k = tables.shape[0]
    s_k = s_words.reshape(k, s_words.shape[0] // k, s_words.shape[1])

    def body(args):
        tab, ss = args
        return cuzk.window_sums_from_table(tab, ss, cfg, geom)

    if k == 1:
        return body((tables[0], s_k[0]))
    wk = jax.lax.map(body, (tables, s_k))  # [k, S, 3, L]
    acc = PointBatch(wk[0, :, 0], wk[0, :, 1], wk[0, :, 2])
    for i in range(1, k):
        acc = ec.add(acc, PointBatch(wk[i, :, 0], wk[i, :, 1], wk[i, :, 2]))
    return jnp.stack([acc.x, acc.y, acc.z], axis=1)


@functools.partial(jax.jit, static_argnames=("cfg", "geom"))
def _plan_msm_point(tables, s_packed, cfg: MsmConfig, geom: MsmGeometry):
    """Cached table + packed scalar words -> ONE standard-form projective
    point [3, L] (device Horner ladder)."""
    return cuzk.msm_point_from_ws(
        _chunk_ws_mont(tables, _unpack_scalar_words(s_packed), cfg, geom),
        cfg,
    )


@functools.partial(jax.jit, static_argnames=("cfg", "geom"))
def _plan_window_sums_std(tables, s_packed, cfg: MsmConfig, geom: MsmGeometry):
    """Cached table + packed scalar words -> standard-form window sums
    [S, 3, L] (multi-chunk path; host merge + Horner finish)."""
    ec = get_curve_ctx(cfg)
    ws = _chunk_ws_mont(tables, _unpack_scalar_words(s_packed), cfg, geom)
    return common.export_points_std(
        ec, PointBatch(ws[:, 0], ws[:, 1], ws[:, 2])
    )


@functools.partial(jax.jit, static_argnames=("cfg", "geom"))
def _plan_msm_point_batched(
    tables, s_packed, cfg: MsmConfig, geom: MsmGeometry
):
    """B packed scalar sets [B, C, W/2] sharing ONE cached table ->
    [B, 3, L] standard-form points, one device program (sequential
    instances inside the jit — device lanes are saturated by a single
    instance's scan, as in ``models/batched.py``)."""

    def one(ss):
        return cuzk.msm_point_from_ws(
            _chunk_ws_mont(tables, _unpack_scalar_words(ss), cfg, geom),
            cfg,
        )

    return jax.lax.map(one, s_packed, batch_size=1)


@functools.partial(jax.jit, static_argnames=("cfg", "geom"))
def _plan_window_sums_std_batched(
    tables, s_packed, cfg: MsmConfig, geom: MsmGeometry
):
    """Batched multi-chunk variant: [B, C, W/2] -> [B, S, 3, L]."""

    def one(ss):
        ec = get_curve_ctx(cfg)
        ws = _chunk_ws_mont(tables, _unpack_scalar_words(ss), cfg, geom)
        return common.export_points_std(
            ec, PointBatch(ws[:, 0], ws[:, 1], ws[:, 2])
        )

    return jax.lax.map(one, s_packed, batch_size=1)


class MsmPlan:
    """A reusable MSM over a fixed point set. Build with ``msm_tpu.plan``."""

    def __init__(
        self,
        points: list[tuple[int, int]],
        config: MsmConfig | None = None,
        geometry: MsmGeometry | None = None,
        validate: bool = False,
    ):
        n = len(points)
        assert n > 0, "plan requires a non-empty point set"
        self.cfg = config or pick_config(n)
        if validate:
            common.validate_inputs(points, [], self.cfg)
        self.n = n
        self.N = common.pad_size(n)
        x_u16, y_u16 = common.pad_points_words(points, self.cfg, self.N)
        self._chunk_n = min(self.N, cuzk.CHUNK_MAX)
        self._slice_n = min(self._chunk_n, cuzk.SLICE)
        self.geom = geometry or pick_geometry(
            self._slice_n, self.cfg.chunk_size
        )
        # per-chunk stacked per-slice tables [k, slice_n, W]
        self._tables = []
        for lo in range(0, self.N, self._chunk_n):
            slices = [
                _prepare_table(
                    jax.device_put(x_u16[s0 : s0 + self._slice_n]),
                    jax.device_put(y_u16[s0 : s0 + self._slice_n]),
                    self.cfg,
                )
                for s0 in range(lo, lo + self._chunk_n, self._slice_n)
            ]
            self._tables.append(jnp.stack(slices))

    def _scalar_words(self, scalars) -> np.ndarray:
        return scalars_to_words(scalars, self.cfg, self.n, self.N)

    def jpoint(self, scalars) -> JPoint:
        """Run the plan over one scalar set -> oracle JPoint."""
        s_all = self._scalar_words(scalars)
        if len(self._tables) == 1:
            sd = jax.device_put(_pack_scalar_words_host(s_all))
            pt = _plan_msm_point(self._tables[0], sd, self.cfg, self.geom)
            return common.std_point_to_jpoint(np.asarray(pt), self.cfg)
        # multi-chunk: standard-form window sums per chunk, exact-int
        # merge + host Horner (compute_msm_jpoint's tail)
        cv = Curve(self.cfg.curve)
        acc = None
        for ci, tab in enumerate(self._tables):
            lo = ci * self._chunk_n
            sd = jax.device_put(
                _pack_scalar_words_host(s_all[lo : lo + self._chunk_n])
            )
            ws = _plan_window_sums_std(tab, sd, self.cfg, self.geom)
            wj = common.window_sums_to_jpoints(np.asarray(ws), self.cfg)
            acc = wj if acc is None else [
                cv.add(a, b) for a, b in zip(acc, wj)
            ]
        return common.horner_window_sums(acc, self.cfg)

    def __call__(self, scalars) -> tuple[int, int] | None:
        """Run the plan -> affine (x, y), or None for the identity."""
        return common.result_to_affine(self.jpoint(scalars), self.cfg)

    def run_batch(self, scalar_sets) -> list[JPoint]:
        """Run B scalar sets as ONE device program sharing the cached
        table (vs ``models/batched.py`` which ships B copies of the point
        inputs — the table reuse is what lifts the HBM cap on B)."""
        if not scalar_sets:
            return []
        s_all = np.stack([self._scalar_words(k) for k in scalar_sets])
        B = s_all.shape[0]
        if len(self._tables) == 1:
            sd = jax.device_put(_pack_scalar_words_host(s_all))
            pts = _plan_msm_point_batched(
                self._tables[0], sd, self.cfg, self.geom
            )
            arr = np.asarray(pts)
            return [
                common.std_point_to_jpoint(arr[b], self.cfg)
                for b in range(B)
            ]
        cv = Curve(self.cfg.curve)
        accs: list[list[JPoint] | None] = [None] * B
        for ci, tab in enumerate(self._tables):
            lo = ci * self._chunk_n
            sd = jax.device_put(
                _pack_scalar_words_host(s_all[:, lo : lo + self._chunk_n])
            )
            ws = _plan_window_sums_std_batched(
                tab, sd, self.cfg, self.geom
            )
            arr = np.asarray(ws)
            for b in range(B):
                wj = common.window_sums_to_jpoints(arr[b], self.cfg)
                accs[b] = wj if accs[b] is None else [
                    cv.add(a, w) for a, w in zip(accs[b], wj)
                ]
        return [common.horner_window_sums(a, self.cfg) for a in accs]


def plan(
    points: list[tuple[int, int]],
    config: MsmConfig | None = None,
    geometry: MsmGeometry | None = None,
    validate: bool = False,
) -> MsmPlan:
    """Prepare an MSM plan over a fixed point set (see module docstring)."""
    return MsmPlan(points, config=config, geometry=geometry, validate=validate)
