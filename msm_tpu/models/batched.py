"""Batched MSM — many independent same-size MSMs in one device program.

The prover-style workload from the driver's BASELINE configs ("batched MSM:
many independent 2^16 instances pipelined"). The reference has no batched
API (one `compute_msm` call per MSM, each paying full host<->GPU setup,
``src/cuzk/msm.rs:75-417``); here all instances ship as one stacked array,
compile once, and run back-to-back on device with no host round-trips in
between — host finalization (the exact Horner tail) is the only per-instance
host work.

Instances are processed sequentially inside one jit (lax.map with
batch_size=1): device lanes are already saturated by a single instance's
scan, so concurrent instances would only inflate the working set.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from msm_tpu.models import common
from msm_tpu.models.cuzk import cuzk_window_sums
from msm_tpu.models.geometry import MsmGeometry, pick_geometry
from msm_tpu.oracle.pyecc import JPoint
from msm_tpu.params import DEFAULT_CONFIG, MsmConfig


@functools.partial(jax.jit, static_argnames=("cfg", "geom"))
def batched_window_sums(
    x_u16: jax.Array,  # [B, n, W]
    y_u16: jax.Array,
    s_u16: jax.Array,
    cfg: MsmConfig,
    geom: MsmGeometry,
) -> jax.Array:
    """[B] stacked instances -> [B, S, 3, L] standard-form window sums."""

    def one(args):
        x, y, s = args
        return cuzk_window_sums.__wrapped__(x, y, s, cfg, geom)

    return jax.lax.map(one, (x_u16, y_u16, s_u16), batch_size=1)


def compute_msm_batched(
    instances: list[tuple[list[tuple[int, int]], list[int]]],
    config: MsmConfig = DEFAULT_CONFIG,
    geometry: MsmGeometry | None = None,
) -> list[JPoint]:
    """Compute many independent MSMs. ``instances``: list of
    (points, scalars) pairs, padded to a common power-of-two size.
    Returns one oracle JPoint per instance."""
    if not instances:
        return []
    nmax = max(len(p) for p, _ in instances)
    xs, ys, ss = [], [], []
    for pts, ks in instances:
        x, y, s = common.pad_inputs(pts, ks, config, multiple=nmax)
        xs.append(x)
        ys.append(y)
        ss.append(s)
    xb, yb, sb = (
        jax.device_put(np.stack(a)) for a in (xs, ys, ss)
    )
    geom = geometry or pick_geometry(xb.shape[1], config.chunk_size)
    ws = np.asarray(batched_window_sums(xb, yb, sb, config, geom))
    return [common.window_sums_to_result(ws[i], config) for i in range(len(instances))]
